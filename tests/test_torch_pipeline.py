"""The port's single-device trio path (denovo_kmer_tpu_torch/pipeline.py, cli.py) against
the JAX package and the scalar oracle, on the CPU: reports byte-equal, tables_n and
candidates equal, on the fixture of tests/test_pipeline_e2e.py."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.io.bam import read_bam_records as jax_read_bam_records
from denovo_kmer_tpu.io.synth import TrioSpec as JaxTrioSpec
from denovo_kmer_tpu.io.synth import make_trio as jax_make_trio
from denovo_kmer_tpu.io.synth import write_trio_bams as jax_write_trio_bams
from denovo_kmer_tpu.oracle.scalar import count_reads, format_report, trio_candidates
from denovo_kmer_tpu.pipeline import build_sample_table as jax_build_sample_table
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu_torch import cli
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops.table import table_from_numpy
from denovo_kmer_tpu_torch.pipeline import ScoringTableBuilder, packed_batches, run_trio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fixture and config of tests/test_pipeline_e2e.py
SPEC = dict(genome_len=3000, read_len=60, coverage=8.0, seed=3,
            n_inherited_snvs=8, n_denovo_snvs=3, n_rate=0.002)
CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 14)


@pytest.fixture(scope="module")
def trio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trio")
    trio = make_trio(TrioSpec(**SPEC))
    return d, trio, write_trio_bams(trio, str(d))


@pytest.fixture(scope="module")
def jax_result(trio_dir):
    _, _, paths = trio_dir
    return jax_run_trio(paths["mom"], paths["dad"], paths["child"], JaxConfig(**CFG))


def _oracle(paths, cfg):
    tables = {s: count_reads([(r.seq, r.qual, r.flag) for r in jax_read_bam_records(p)], cfg)
              for s, p in paths.items()}
    cands = trio_candidates(tables["mom"], tables["dad"], tables["child"], cfg)
    return format_report(cands, cfg.k), cands, {s: len(t) for s, t in tables.items()}


def test_run_trio_matches_jax_byte_exact(trio_dir, jax_result):
    _, _, paths = trio_dir
    res = run_trio(paths["mom"], paths["dad"], paths["child"], EngineConfig(**CFG),
                   device="cpu")
    assert res.report == jax_result.report
    assert res.tables_n == jax_result.tables_n
    assert res.candidates == jax_result.candidates
    assert len(res.candidates) > 0
    assert res.metrics.counters["batches"] == jax_result.metrics.counters["batches"]


@pytest.mark.parametrize("k", [32, 33])
def test_run_trio_matches_oracle(trio_dir, k):
    """k=32 takes the call_from_score fallback (2k % 32 == 0); k=33 has 3-word keys."""
    _, _, paths = trio_dir
    cfg = dict(CFG, k=k, accum_batches=2)  # several flushes per sample
    want_report, want_cands, want_n = _oracle(paths, JaxConfig(**cfg))
    res = run_trio(paths["mom"], paths["dad"], paths["child"], EngineConfig(**cfg),
                   device="cpu")
    assert res.report == want_report
    assert res.candidates == want_cands
    assert res.tables_n == want_n
    assert len(want_cands) > 0


def test_fastq_input_matches_oracle(tmp_path):
    seqs = ["ACGTACGTACGTACGTACGT", "TTTTTTTTTTTTTTTT", "ACGNNCGTACGTACGT",
            "GGGATTACAGGGATTACAGG"]
    paths = {}
    for s, picks in (("mom", [0]), ("dad", [1]), ("child", [0, 2, 3, 3])):
        paths[s] = str(tmp_path / f"{s}.fastq")
        with open(paths[s], "w") as f:
            for i in picks:
                f.write(f"@r{i}\n{seqs[i]}\n+\n{'I' * len(seqs[i])}\n")
    cfg = dict(k=11, max_read_len=32, batch_reads=16, table_capacity=1 << 12)
    tables = {}
    for s, p in paths.items():
        with open(p) as f:
            lines = f.read().split("\n")
        tables[s] = count_reads([(q, None, 0) for q in lines[1::4]], JaxConfig(**cfg))
    want = trio_candidates(tables["mom"], tables["dad"], tables["child"], JaxConfig(**cfg))
    res = run_trio(paths["mom"], paths["dad"], paths["child"], EngineConfig(**cfg),
                   device="cpu")
    assert res.candidates == want and len(want) > 0
    assert res.report == format_report(want, 11)


def test_make_trio_gives_the_jax_records():
    spec = dict(SPEC, error_rate=0.01)
    got, want = make_trio(TrioSpec(**spec)), jax_make_trio(JaxTrioSpec(**spec))
    assert got.reference == want.reference
    assert got.denovo_positions == want.denovo_positions
    for s in ("mom", "dad", "child"):
        assert [dataclasses.astuple(r) for r in got.reads[s]] == \
               [dataclasses.astuple(r) for r in want.reads[s]]


def test_bam_files_and_records_match_jax(trio_dir, tmp_path):
    _, trio, paths = trio_dir
    jpaths = jax_write_trio_bams(jax_make_trio(JaxTrioSpec(**SPEC)), str(tmp_path))
    for s in ("mom", "dad", "child"):
        with open(paths[s], "rb") as a, open(jpaths[s], "rb") as b:
            assert a.read() == b.read()
        got = [dataclasses.astuple(r) for r in read_bam_records(paths[s])]
        assert got == [dataclasses.astuple(r) for r in jax_read_bam_records(paths[s])]
        assert got == [dataclasses.astuple(r) for r in trio.reads[s]]


def test_jax_parent_tables_feed_the_port_scorer(trio_dir, jax_result):
    """Parent tables built by the JAX package, carried across as numpy arrays, give the
    port's scoring build the same candidates."""
    _, _, paths = trio_dir
    jcfg, cfg = JaxConfig(**CFG), EngineConfig(**CFG)
    parents = []
    for s in ("mom", "dad"):
        jt = jax_build_sample_table(paths[s], jcfg)
        parents.append(table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts),
                                        int(jt.n)))
    cands, _, child_n = ScoringTableBuilder(cfg, device="cpu").build_call(
        *parents, packed_batches(paths["child"], cfg))
    n = int(cands.n)
    got = [(tuple(int(w) for w in cands.keys[i]), int(cands.child_counts[i]),
            int(cands.mom_counts[i]), int(cands.dad_counts[i])) for i in range(n)]
    want = [(tuple((v >> (32 * (cfg.words - 1 - w))) & 0xFFFFFFFF for w in range(cfg.words)),
             c, m, d) for v, c, m, d in jax_result.candidates]
    assert got == want
    assert child_n == jax_result.tables_n["child"]


def test_cuda_request_without_a_card_raises(trio_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the request is valid")
    _, _, paths = trio_dir
    with pytest.raises(RuntimeError, match="CUDA"):
        run_trio(paths["mom"], paths["dad"], paths["child"], EngineConfig(**CFG))


def test_cli_call_cpu_matches_jax_cli(trio_dir, tmp_path):
    _, _, paths = trio_dir
    common = ["call", "--mom", paths["mom"], "--dad", paths["dad"], "--child",
              paths["child"], "-k", "21", "--max-read-len", "64", "--batch-reads", "64",
              "--table-capacity", str(1 << 14)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for pkg, extra in (("denovo_kmer_tpu", []), ("denovo_kmer_tpu_torch", ["--device", "cpu"])):
        out[pkg] = tmp_path / f"{pkg}.tsv"
        r = subprocess.run([sys.executable, "-m", pkg, *common, *extra, "-o", str(out[pkg])],
                           capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        assert r.returncode == 0, r.stderr
        assert "candidates:" in r.stderr
    assert out["denovo_kmer_tpu_torch"].read_text() == out["denovo_kmer_tpu"].read_text()
    assert out["denovo_kmer_tpu"].read_text().count("\n") > 1


@pytest.mark.parametrize("flag", [
    ["--passes", "2", "--mesh", "2x2"], ["--mesh", "2x1"],
    ["--spill-rows", "1000", "--passes", "2", "--mesh", "1x2"],
    ["--spill-rows", "1000", "--passes", "2", "--mesh", "2x1"], ["--region", "chr20"],
    # the length buckets and the feeder threads are live, but not beside an unported flag
    ["--regions-bed", "r.bed"], ["--read-len-buckets", "32,64", "--mesh", "2x2"],
    ["--ingest-threads", "4", "--region", "chr20"],
    # evidence and sites are live, but not beside an unported flag
    ["--profile-dir", "prof"], ["--evidence-out", "ev.bam", "--region", "chr20"],
    ["--sites-out", "s.tsv", "--mesh", "2x2"],
])
def test_cli_rejects_unported_flags(trio_dir, flag, capsys):
    _, _, paths = trio_dir
    with pytest.raises(SystemExit) as e:
        cli.main(["call", "--mom", paths["mom"], "--dad", paths["dad"], "--child",
                  paths["child"], "--device", "cpu", *flag])
    assert "not yet ported (ROADMAP.md)" in str(e.value.code)


def test_synth_trio_cli_writes_what_the_jax_cli_writes(tmp_path):
    from denovo_kmer_tpu import cli as jax_cli

    args = ["--genome-len", "2000", "--coverage", "3", "--denovo", "2", "--seed", "4"]
    assert cli.main(["synth-trio", str(tmp_path / "port"), *args]) == 0
    assert jax_cli.main(["synth-trio", str(tmp_path / "jax"), *args]) == 0
    for name in ("mom.bam", "dad.bam", "child.bam", "truth.vcf", "ref.fa"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    meta = {d: json.loads((tmp_path / d / "trio.json").read_text()) for d in ("port", "jax")}
    assert meta["port"]["denovo_positions"] == meta["jax"]["denovo_positions"]
    assert meta["port"]["spec"] == meta["jax"]["spec"]
