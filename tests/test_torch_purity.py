"""The PyTorch/CUDA port stands alone: no file of denovo_kmer_tpu_torch/ (nor chip_smoke.py)
imports jax, jaxlib or the JAX package, importing the port loads none of them, and its C++
feeder is compiled from the port's own sources."""

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
        "import denovo_kmer_tpu_torch.ops.block_sort, denovo_kmer_tpu_torch.utils.checkpoint\n"
        "import denovo_kmer_tpu_torch.io.native, denovo_kmer_tpu_torch.io.sam\n"
        "import denovo_kmer_tpu_torch.cohort, denovo_kmer_tpu_torch.sites\n"
        "import denovo_kmer_tpu_torch.io.cram, denovo_kmer_tpu_torch.io.crai\n"
        "import denovo_kmer_tpu_torch.io.bai, denovo_kmer_tpu_torch.io.remote\n"
        "import denovo_kmer_tpu_torch.io.objstore, denovo_kmer_tpu_torch.io.tok3\n"
        "import denovo_kmer_tpu_torch.io.fqz, denovo_kmer_tpu_torch.io.fasta\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


def test_native_feeder_builds_from_the_port_sources(tmp_path, monkeypatch):
    """The g++ command of io/native.py compiles only files under denovo_kmer_tpu_torch/io/
    _native/ (the BAM feeder and the three CRAM codec sources), and writes into the port's
    build directory."""
    from denovo_kmer_tpu_torch.io import native

    assert native.library_path().startswith(os.path.join(PORT, "io", "_native", "build"))
    commands = []

    def fake_run(cmd, **kw):
        commands.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    monkeypatch.setattr(native.os, "replace", lambda a, b: None)
    assert native._build(str(tmp_path / "lib.so")) is None
    sources = [a for a in commands[0] if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [os.path.join(PORT, "io", "_native", f) for f in
                       ("bam_ingest.cpp", "rans_codec.cpp", "cram_util.cpp", "arith_codec.cpp")]
    for src in sources:
        with open(src) as f:
            assert "#include \"" not in f.read()  # no header from another tree
