"""The benchmark's files: BENCHMARK.json against its contract, every configuration,
traffic mix and metric found by name, and no JAX anywhere the harness runs."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from gpubench import harness, reads
from gpubench.run import FORBIDDEN

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"] and BENCH["paths"] == ["gpubench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for kind, keys in KEYS.items():
        for e in BENCH[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (kind, e["name"])
            assert NAME.match(e["name"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in configs.values():
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("gpubench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    for w in cells.values():
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        reported = [m["name"] for m in BENCH["end_to_end"] if w in m.get("workloads", [w])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m.get("workloads", [w]) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_finds_its_files_by_name(workload, trace):
    cell = harness.load_cell(workload, trace)
    assert cell.metrics and all(callable(harness.metric_reader(m["name"]))
                                for m in cell.metrics)
    reads.ReadSpec(**cell.traffic["reads"])
    assert cell.traffic["route"]["table_capacity"] > 0
    assert callable(harness.entry_of(cell.config))
    args = harness.engine_args(cell.config, cell.traffic, "cpu")
    assert harness.run_ks(args)
    config = next(c for c in BENCH["configs"]
                  if c["name"] == next(w for w in BENCH["workloads"]
                                       if w["name"] == workload)["config"])
    for key in config["reduced"]:
        assert key in cell.config


def test_every_file_is_used():
    used = {f"{m['name']}.py" for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert set(os.listdir(os.path.join(harness.HERE, "metrics"))) - {"__pycache__"} == used
    configs = {os.path.basename(c["file"]) for c in BENCH["configs"]}
    assert set(os.listdir(os.path.join(harness.HERE, "configs"))) == configs
    traffic = {f"{w['traffic']}.json" for w in BENCH["workloads"]}
    assert set(os.listdir(os.path.join(harness.HERE, "traffic"))) == traffic


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def _sources():
    for d, _subdirs, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = _top_imports(path) & set(FORBIDDEN)
    assert not found, f"{path} imports {found}"


def test_the_reference_and_its_reads_import_nothing_of_the_port():
    for name in ("reference.py", "reads.py"):
        names = _top_imports(os.path.join(harness.HERE, name))
        assert "denovo_kmer_tpu_torch" not in names and names <= {
            "__future__", "dataclasses", "hashlib", "typing", "numpy", "torch"}, names


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from gpubench import run

    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    monkeypatch.setitem(sys.modules, "denovo_kmer_tpu_torchx", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_a_cpu_run_leaves_no_jax_in_sys_modules():
    script = (
        "import sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])\n"
        "from conftest import tiny_cell\n"
        "from gpubench import harness, run\n"
        "out = harness.run_cell(tiny_cell(), 3, 0.2, True, 'cpu')\n"
        "assert out['correct'], out\n"
        "print(run.forbidden_modules(), 'denovo_kmer_tpu_torch' in sys.modules)\n")
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", script, harness.ROOT, here],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[-2] == "[] True"


def test_run_exits_without_a_result_where_the_cell_needs_a_card():
    r = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
