"""Length bucketing in the port (cfg.read_len_buckets: ops/pack.pack_records_bucketed,
pipeline.make_bucketed_extract_steps, SampleTableBuilder.build(bucket_steps=), the bucketed child
scoring, multipass and spill) against the JAX package on tests/test_bucketing.py's mixed-length
fixture, on one device: bucketed batches equal JAX's, bucketed tables and reports equal the
unbucketed run and JAX's report, while staging far fewer windows. Tolerance 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops.pack import pack_records_bucketed as jax_pack_records_bucketed
from denovo_kmer_tpu.pipeline import _record_stream as jax_record_stream
from denovo_kmer_tpu.pipeline import build_sample_table as jax_build_sample_table
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu.pipeline import run_trio_multipass as jax_run_trio_multipass
from denovo_kmer_tpu.pipeline import run_trio_spill as jax_run_trio_spill
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import BamRecord, BamWriter, read_bam_records
from denovo_kmer_tpu_torch.ops import extract
from denovo_kmer_tpu_torch.ops.pack import pack_records_bucketed
from denovo_kmer_tpu_torch.ops.table import table_to_numpy
from denovo_kmer_tpu_torch.pipeline import (
    build_sample_table,
    run_trio,
    run_trio_multipass,
    run_trio_spill,
)
from denovo_kmer_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fixture and configs of tests/test_bucketing.py
PLAIN = dict(k=21, max_read_len=160, batch_reads=64, table_capacity=1 << 14)
BUCK = dict(PLAIN, read_len_buckets=(64, 96, 160))


def _mixed_len_bam(path, rng, genome, n=600):
    with open(path, "wb") as f, BamWriter(f, references=[("c", len(genome))]) as w:
        for i in range(n):
            L = int([36, 50, 76, 100, 151][i % 5])
            p = int(rng.integers(0, len(genome) - L))
            w.write(BamRecord(name=f"r{i}", flag=0, refid=0, pos=p, cigar=((L, 0),),
                              seq=genome[p:p + L], qual=tuple([30] * L)))
    return path


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """tests/test_bucketing.py's trio, with three SNVs in the child's genome so that the
    reports hold candidates."""
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("buckets")
    g = "".join(np.random.default_rng(7).choice(list("ACGT"), 4000))
    child = list(g)
    for pos in (1000, 2000, 3000):
        child[pos] = "ACGT"[("ACGT".index(g[pos]) + 1) % 4]
    genomes = {"mom": g, "dad": g, "child": "".join(child)}
    return {s: _mixed_len_bam(str(d / f"{s}.bam"), rng, genomes[s])
            for s in ("mom", "dad", "child")}


@pytest.fixture(scope="module")
def golden(mixed):
    """The JAX package's unbucketed report of the mixed trio."""
    return jax_run_trio(mixed["mom"], mixed["dad"], mixed["child"], JaxConfig(**PLAIN))


def _trio(mixed):
    return mixed["mom"], mixed["dad"], mixed["child"]


@pytest.mark.parametrize("minq", [0, 35])
def test_pack_records_bucketed_matches_jax(mixed, minq):
    cfg = dict(BUCK, min_base_quality=minq)
    got = list(pack_records_bucketed(read_bam_records(mixed["child"]), EngineConfig(**cfg)))
    want = list(jax_pack_records_bucketed(jax_record_stream(mixed["child"], JaxConfig(**cfg)),
                                          JaxConfig(**cfg)))
    assert [w for w, _ in got] == [w for w, _ in want]
    assert {w for w, _ in got} == {64, 96, 160}
    for (_, p), (_, q) in zip(got, want):
        assert (p.n_reads, p.prefix_valid) == (q.n_reads, q.prefix_valid)
        for f in ("words", "vwords", "length"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))


def test_bucketed_table_bit_identical(mixed):
    m = Metrics()
    t1 = build_sample_table(mixed["child"], EngineConfig(**BUCK), m, device="cpu")
    t0 = build_sample_table(mixed["child"], EngineConfig(**PLAIN), device="cpu")
    want = jax_build_sample_table(jax_record_stream(mixed["child"], JaxConfig(**BUCK)),
                                  JaxConfig(**BUCK))
    for t in (t0, t1):
        keys, counts, n = table_to_numpy(t)
        assert n == int(want.n)
        np.testing.assert_array_equal(keys, np.asarray(want.keys))
        np.testing.assert_array_equal(counts, np.asarray(want.counts))
    # waste check: staged windows well under the all-at-160 figure
    worst = m.counters["reads_ingested"] // 64 * 64 * (160 - 21 + 1)
    assert m.counters["windows_staged"] < 0.75 * worst


def test_bucketed_trio_call_identical(mixed, golden):
    r1 = run_trio(*_trio(mixed), EngineConfig(**BUCK), device="cpu")
    r0 = run_trio(*_trio(mixed), EngineConfig(**PLAIN), device="cpu")
    want = jax_run_trio(*_trio(mixed), JaxConfig(**BUCK))
    for r in (r0, r1, want):
        assert r.report == golden.report
        assert r.tables_n == golden.tables_n
    assert r1.candidates == golden.candidates and len(golden.candidates) > 0
    # the bucketed run extracts width-proportional windows
    assert r1.metrics.counters["kmers_extracted"] < 0.75 * r0.metrics.counters["kmers_extracted"]


def test_bucketed_even_k_run_trio_fails_as_jax_does(mixed):
    """k=32 has no fused call, and the compacting child build takes no bucketed stream: JAX's
    run_trio fails on the stream's (width, batch) pairs, and the port refuses the config
    before it builds anything. The multipass streams that child unbucketed in both."""
    with pytest.raises(AttributeError, match="n_reads"):
        jax_run_trio(*_trio(mixed), JaxConfig(**dict(BUCK, k=32)))
    m = Metrics()
    with pytest.raises(ValueError, match="no bucketed variant"):
        run_trio(*_trio(mixed), EngineConfig(**dict(BUCK, k=32)), m, device="cpu")
    assert not m.seconds and not m.counters


@pytest.mark.parametrize("k", [21, 32])
def test_bucketed_multipass_identical(mixed, golden, k):
    """buckets × passes: per-(width, pass) steps; k=32 the unbucketed child fallback."""
    cfg = dict(BUCK, k=k, table_capacity=1 << 13)
    want = jax_run_trio_multipass(*_trio(mixed), JaxConfig(**cfg), 2)
    got = run_trio_multipass(*_trio(mixed), EngineConfig(**cfg), 2, device="cpu")
    assert got.report == want.report and got.tables_n == want.tables_n
    if k == 21:
        assert got.report == golden.report


@pytest.mark.parametrize("sink", ["store", "host"])
def test_bucketed_spill_identical(mixed, golden, tmp_path, sink):
    kw = (dict(device_store_rows=1 << 16) if sink == "store"
          else dict(spill_dir=str(tmp_path / "spill")))
    cfg = dict(BUCK, accum_batches=2)  # several partition windows a sample
    got = run_trio_spill(*_trio(mixed), EngineConfig(**cfg), 3, device="cpu", **kw)
    kw_jax = (kw if sink == "store" else dict(spill_dir=str(tmp_path / "jax_spill")))
    want = jax_run_trio_spill(*_trio(mixed), JaxConfig(**cfg), 3, **kw_jax)
    assert got.report == want.report == golden.report
    assert got.tables_n == want.tables_n
    if sink == "host":
        for f in sorted(os.listdir(tmp_path / "jax_spill")):
            if f.endswith(".bin"):
                assert (tmp_path / "spill" / f).read_bytes() == \
                       (tmp_path / "jax_spill" / f).read_bytes()


def test_cli_read_len_buckets_matches_jax_cli(mixed, tmp_path):
    common = ["call", "--mom", mixed["mom"], "--dad", mixed["dad"], "--child", mixed["child"],
              "-k", "21", "--max-read-len", "160", "--batch-reads", "64", "--table-capacity",
              str(1 << 14), "--read-len-buckets", "64,96,160"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for pkg, extra in (("denovo_kmer_tpu", []), ("denovo_kmer_tpu_torch", ["--device", "cpu"])):
        out[pkg] = tmp_path / f"{pkg}.tsv"
        r = subprocess.run([sys.executable, "-m", pkg, *common, *extra, "-o", str(out[pkg])],
                           capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        assert r.returncode == 0, r.stderr
    assert out["denovo_kmer_tpu_torch"].read_text() == out["denovo_kmer_tpu"].read_text()
    assert out["denovo_kmer_tpu"].read_text().count("\n") > 1


@pytest.mark.parametrize("width", [32, 36, 64, 112, 160])
@pytest.mark.parametrize("vwords", [False, True])
def test_tile_reads_fits_shared_memory_at_narrow_widths(width, vwords):
    """The extraction kernel's launch at each bucket width (k=31): a read's stream words, and
    the W + 1 a window reads past its first, fit the lanes that hold them (16 or 32 lanes a
    read, one chunk), and so do the 3 validity words a window reads; half a warp a read
    where that needs at most 3/4 of the warp steps of a whole warp (width 64 only)."""
    k = 31
    Lw = -(-width // 32) * 2
    P = width - k + 1
    W = 2
    lanes = extract._lanes_per_read(Lw, k, P)
    assert Lw <= extract._chunk_words(k) and Lw + W + 1 <= lanes
    if vwords:
        assert Lw // 2 + 3 <= lanes
    assert (lanes == 16) == (2 * -(-P // 16) <= 3 * -(-P // 32))
    assert (lanes == 16) == (width in (32, 36, 64))
