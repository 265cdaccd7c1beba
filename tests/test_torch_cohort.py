"""The port's multi-k sweep and cohort mode (denovo_kmer_tpu_torch/cohort.py) against the
JAX package's run_trio_multi_k and run_cohort on the CPU, on the fixtures of
tests/test_cohort.py: reports, candidates and tables_n equal, the parental superset's keys,
counts and n equal. Tolerance: byte-equal."""

import dataclasses

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.cohort import TrioPaths as JaxTrioPaths
from denovo_kmer_tpu.cohort import run_cohort as jax_run_cohort
from denovo_kmer_tpu.cohort import run_trio_multi_k as jax_run_trio_multi_k
from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu_torch import cohort
from denovo_kmer_tpu_torch.cohort import TrioPaths, run_cohort, run_trio_multi_k
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops import extract, fused
from denovo_kmer_tpu_torch.ops.table import table_to_numpy
from denovo_kmer_tpu_torch.pipeline import TableOverflowError, build_sample_table, run_trio
from denovo_kmer_tpu_torch.utils.checkpoint import save_table
from denovo_kmer_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

SWEEP_CFG = dict(k=31, max_read_len=64, batch_reads=64, table_capacity=1 << 13)
COHORT_CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 14)


def _write_trios(d, n, genome_len, seed0, n_inherited):
    out = []
    for i in range(n):
        spec = TrioSpec(genome_len=genome_len, read_len=50, coverage=5.0, seed=seed0 + i,
                        n_inherited_snvs=n_inherited, n_denovo_snvs=2)
        paths = write_trio_bams(make_trio(spec), str(d / f"t{i}"))
        out.append(TrioPaths(name=f"t{i}", mom=paths["mom"], dad=paths["dad"],
                             child=paths["child"]))
    return out


@pytest.fixture(scope="module")
def trios(tmp_path_factory):
    """tests/test_cohort.py's three trios."""
    return _write_trios(tmp_path_factory.mktemp("cohort"), 3, 1200, 40, 5)


@pytest.fixture(scope="module")
def trios8(tmp_path_factory):
    """tests/test_cohort.py's eight trios (BASELINE config 5's count)."""
    return _write_trios(tmp_path_factory.mktemp("cohort8"), 8, 900, 70, 4)


def _jax_trios(trios):
    return [JaxTrioPaths(**dataclasses.asdict(t)) for t in trios]


def _same_results(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].report == want[key].report, key
        assert got[key].candidates == want[key].candidates, key
        assert got[key].tables_n == want[key].tables_n, key


@pytest.mark.parametrize("ks", [(15, 21, 31), (15, 32, 33)])
def test_sweep_matches_jax(trios, ks):
    tp = trios[0]
    want = jax_run_trio_multi_k(tp.mom, tp.dad, tp.child, JaxConfig(**SWEEP_CFG), list(ks))
    got = run_trio_multi_k(tp.mom, tp.dad, tp.child, EngineConfig(**SWEEP_CFG), ks,
                           device="cpu")
    _same_results(got, want)
    assert all(want[k].candidates for k in ks)


def test_sweep_chooses_the_call_per_k(trios, monkeypatch):
    """(15, 32, 33): k=32 takes the compacting build and call_from_score, 15 and 33 the
    fused call (the JAX package sends all three to call_from_score), and each k equals the
    port's own run_trio at that k."""
    tp = trios[0]
    calls = []
    real = fused.fused_call_full

    def spy(acc, tab, *a, **kw):
        calls.append(acc.kmers.shape[1])
        return real(acc, tab, *a, **kw)

    monkeypatch.setattr("denovo_kmer_tpu_torch.pipeline.fused_call_full", spy)
    base = EngineConfig(**SWEEP_CFG)
    got = run_trio_multi_k(tp.mom, tp.dad, tp.child, base, (15, 32, 33), device="cpu")
    assert sorted(calls) == [1, 3]  # k=15 (1 key word) and k=33 (3); not k=32
    for k in (15, 32, 33):
        solo = run_trio(tp.mom, tp.dad, tp.child, dataclasses.replace(base, k=k),
                        device="cpu")
        assert (got[k].report, got[k].tables_n) == (solo.report, solo.tables_n)


def test_sweep_decodes_each_sample_once(trios, monkeypatch):
    """One decode a sample for every k: the feeder's batches are those of one sample pass
    each, and every batch is extracted once a k."""
    tp = trios[0]
    ks = (15, 21, 31, 41)
    fed, extracted = [], []
    real_batches = cohort.packed_batches
    real_plain = extract.append_plain

    def counted_batches(*a, **kw):
        for p in real_batches(*a, **kw):
            fed.append(p.n_reads)
            yield p

    def counted_plain(acc, words, *a, **kw):
        extracted.append(words.shape[0])
        return real_plain(acc, words, *a, **kw)

    monkeypatch.setattr(cohort, "packed_batches", counted_batches)
    monkeypatch.setattr(extract, "append_plain", counted_plain)
    m = Metrics()
    run_trio_multi_k(tp.mom, tp.dad, tp.child, EngineConfig(**SWEEP_CFG), ks, m, device="cpu")
    assert len(extracted) == len(ks) * len(fed)
    single = Metrics()
    run_trio(tp.mom, tp.dad, tp.child, EngineConfig(**SWEEP_CFG), single, device="cpu")
    assert len(fed) == m.counters["batches"] == single.counters["batches"]
    assert m.counters["reads_ingested"] == sum(fed) == single.counters["reads_ingested"]
    assert m.counters["kmers_extracted"] == sum(
        sum(fed) * (SWEEP_CFG["max_read_len"] - k + 1) for k in ks)


def _superset_equal(got, want):
    keys, counts, n = table_to_numpy(got)
    want_n = int(want.n)
    assert n == want_n
    np.testing.assert_array_equal(keys, np.asarray(want.keys))
    np.testing.assert_array_equal(counts, np.asarray(want.counts))


def test_cohort_matches_jax(trios):
    want, want_sup = jax_run_cohort(_jax_trios(trios), JaxConfig(**COHORT_CFG))
    got, got_sup = run_cohort(trios, EngineConfig(**COHORT_CFG), device="cpu")
    _same_results(got, want)
    _superset_equal(got_sup, want_sup)
    for tp in trios:  # each trio's result is its standalone run_trio
        solo = run_trio(tp.mom, tp.dad, tp.child, EngineConfig(**COHORT_CFG), device="cpu")
        assert got[tp.name].report == solo.report


def test_cohort_eight_trios_matches_jax(trios8):
    want, want_sup = jax_run_cohort(_jax_trios(trios8), JaxConfig(**COHORT_CFG))
    got, got_sup = run_cohort(trios8, EngineConfig(**COHORT_CFG), device="cpu")
    _same_results(got, want)
    _superset_equal(got_sup, want_sup)
    got_none, sup_none = run_cohort(trios8[:2], EngineConfig(**COHORT_CFG),
                                    build_parental_superset=False, device="cpu")
    assert sup_none is None
    assert {k: v.report for k, v in got_none.items()} == {
        k: got[k].report for k in got_none}


def test_cohort_superset_overflow_raises(trios):
    """A capacity that holds each trio's tables but not the union of two trios' parents:
    both packages raise, the port naming the trio and the parent."""
    _, sup = run_cohort(trios[:1], EngineConfig(**COHORT_CFG), device="cpu")
    cap = int(sup.n) + 300
    with pytest.raises(RuntimeError, match="superset"):
        jax_run_cohort(_jax_trios(trios[:2]), JaxConfig(**{**COHORT_CFG, "table_capacity": cap}))
    with pytest.raises(TableOverflowError, match=r"superset overflow at trio t1 \((mom|dad)\)"):
        run_cohort(trios[:2], EngineConfig(**{**COHORT_CFG, "table_capacity": cap}),
                   device="cpu")


def test_cohort_npz_parent_matches_jax(trios, tmp_path):
    """A `count` checkpoint as a parent in the manifest loads instead of building, in both
    packages, with the same results and superset."""
    cfg = EngineConfig(**COHORT_CFG)
    tp = trios[1]
    npz = str(tmp_path / "mom.npz")
    save_table(npz, build_sample_table(tp.mom, cfg, device="cpu"), cfg, source=tp.mom)
    mixed = [trios[0], dataclasses.replace(tp, mom=npz)]
    want, want_sup = jax_run_cohort(_jax_trios(mixed), JaxConfig(**COHORT_CFG))
    got, got_sup = run_cohort(mixed, cfg, device="cpu")
    _same_results(got, want)
    _superset_equal(got_sup, want_sup)
    plain, _ = run_cohort(trios[:2], cfg, device="cpu")
    assert got[tp.name].report == plain[tp.name].report


@pytest.mark.cuda
def test_sweep_and_cohort_on_cuda_equal_cpu(trios):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 3 runs this on the H100)")
    tp = trios[0]
    base = EngineConfig(**SWEEP_CFG)
    for k_set in ((15, 21, 31), (15, 32, 33)):
        gpu = run_trio_multi_k(tp.mom, tp.dad, tp.child, base, k_set, device="cuda")
        cpu = run_trio_multi_k(tp.mom, tp.dad, tp.child, base, k_set, device="cpu")
        _same_results(gpu, cpu)
    gpu, gpu_sup = run_cohort(trios, EngineConfig(**COHORT_CFG), device="cuda")
    cpu, cpu_sup = run_cohort(trios, EngineConfig(**COHORT_CFG), device="cpu")
    _same_results(gpu, cpu)
    assert [a.tolist() for a in table_to_numpy(gpu_sup)[:2]] == [
        a.tolist() for a in table_to_numpy(cpu_sup)[:2]]
