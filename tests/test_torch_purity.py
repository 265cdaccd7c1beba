"""The PyTorch/CUDA port stands alone: no file of denovo_kmer_tpu_torch/ (nor chip_smoke.py)
imports jax, jaxlib or the JAX package, and importing the port loads none of them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "denovo_kmer_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "denovo_kmer_tpu")

SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(PORT)
    for f in files
    if f.endswith(".py")
) + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_jax(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{rel} imports {bad}"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import denovo_kmer_tpu_torch.cli, denovo_kmer_tpu_torch.pipeline\n"
        "import denovo_kmer_tpu_torch.ops.extract, denovo_kmer_tpu_torch.io.synth\n"
        "import denovo_kmer_tpu_torch.ops.spill, denovo_kmer_tpu_torch.ops.partition\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""
