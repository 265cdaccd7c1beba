"""BASELINE config 4 at a real size (chip_smoke.py phase 13) and the port's repairs for it, on
the CPU at a small size: the sweep at k = 15, 21, 31, 41 on phase 12's trio generator
against the JAX package's ``run_trio_multi_k`` and against phase 13's numpy reference (its
bounded-memory ``scale_counts``), the release of each lane's parental tables once that lane
is seeded, the ``--accum-batches auto`` plan over a sweep's ks, and the reference's helpers
(the two-word canonical k-mers, ``lex_order``, the memory check)."""

import argparse
import gc
import io
import os
import sys
import weakref
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.cohort import run_trio_multi_k as jax_run_trio_multi_k
from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu_torch import cli, cohort, pipeline
from denovo_kmer_tpu_torch.config import EngineConfig, words_per_kmer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (the smoke script's fixtures)

torch.set_num_threads(1)

KS = (15, 21, 31, 41)
# phase 12's rates on a small genome: ~40 kbp at 12x
SMALL = cs.ScaleSpec(genome_len=40_000, coverage=12, chunk_reads=800, seed=13)
CFG = dict(k=31, max_read_len=160, batch_reads=1024, accum_batches=2,
           table_capacity=1 << 17)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """Phase 12's generator and writer on SMALL, with its reference at k = 31."""
    work = str(tmp_path_factory.mktemp("sweep"))
    return work, cs.scale_trio(SMALL, work, k=31, n_buckets=8, workers=2)


@pytest.fixture(scope="module")
def sweep(trio):
    _, data = trio
    paths = data["paths"]
    return cohort.run_trio_multi_k(paths["mom"], paths["dad"], paths["child"],
                                   EngineConfig(**CFG), KS, device="cpu")


def test_sweep_matches_jax_on_the_scale_trio(trio, sweep):
    _, data = trio
    paths = data["paths"]
    want = jax_run_trio_multi_k(paths["mom"], paths["dad"], paths["child"], JaxConfig(**CFG),
                                KS)
    assert sorted(sweep) == sorted(want) == sorted(KS)
    for k in KS:
        assert sweep[k].report == want[k].report
        assert sweep[k].tables_n == want[k].tables_n
    assert sweep[31].report == cs.report_text(data["candidates"], 31)
    assert sweep[31].tables_n == {s: r["n"] for s, r in data["ref"].items()}


@pytest.mark.parametrize("k,live", [(15, 1), (21, 2), (41, 2), (41, 3)])
def test_sweep_matches_the_bounded_numpy_reference(trio, sweep, k, live, tmp_path):
    """Phase 13's reference at k without BAMs, at most ``live`` samples' buffers at once:
    the sweep's report and tables_n at that k equal it."""
    work, _ = trio
    ref = cs.scale_counts(SMALL, work, str(tmp_path), k, n_buckets=8, workers=2, live=live)
    assert ref["paths"] == {}
    assert sweep[k].report == cs.report_text(ref["candidates"], k)
    assert sweep[k].tables_n == {s: r["n"] for s, r in ref["ref"].items()}
    assert len(ref["candidates"]) > 0


def test_sweep_releases_each_lanes_parental_tables_once_seeded(trio, monkeypatch):
    """The lanes seed narrowest first; once a lane is seeded nothing holds its mom or dad
    table, so when the next lane seeds (and when the child streams) every earlier lane's
    parents are gone; the reports are unchanged."""
    _, data = trio
    paths = data["paths"]
    refs, order, checks = [], [], []
    real_lane, real_fold = pipeline.ScoringTableBuilder.child_lane, cohort._fold_placed

    def dead():
        gc.collect()
        return [r() is None for r in refs]

    def child_lane(self, mom, dad, bucket_steps=None):
        checks.append(dead())
        refs.extend([weakref.ref(mom.keys), weakref.ref(dad.keys)])
        order.append(self.cfg.k)
        return real_lane(self, mom, dad, bucket_steps)

    def fold(batches, cfg, dev, lanes, m, bucketed=False):
        if type(lanes[0].state) is tuple:  # the child's lanes: (scoring table, flushed)
            checks.append(dead())
        return real_fold(batches, cfg, dev, lanes, m, bucketed)

    monkeypatch.setattr(pipeline.ScoringTableBuilder, "child_lane", child_lane)
    monkeypatch.setattr(cohort, "_fold_placed", fold)
    got = cohort.run_trio_multi_k(paths["mom"], paths["dad"], paths["child"],
                                  EngineConfig(**CFG), (41, 31, 21, 15), device="cpu")
    assert order == [15, 21, 31, 41]
    assert checks == [[True] * (2 * i) for i in range(len(KS) + 1)]
    assert got[31].report == cs.report_text(data["candidates"], 31)


GRID = [dict(mem=m, capacity=c, max_read_len=160, batch_reads=b)
        for m in (16 << 30, 85_017_493_504) for c in (1 << 20, 1 << 24, 1 << 26, 1 << 28)
        for b in (4096, 16384)]


@pytest.mark.parametrize("ks", [(31,), (15, 31), (15, 21, 31, 41), (41, 21), (33, 63)])
def test_auto_window_plan_over_a_sweeps_ks(ks):
    """The plan is the largest window whose modelled peak over every lane fits the budget
    (or one batch); the summed model bounds each lane's own; one k gives the single-k plan;
    the staging rows are each lane's window, summed."""
    for g in GRID:
        plan = cli.auto_window_plan(g["mem"], g["capacity"], list(ks), g["max_read_len"],
                                    g["batch_reads"])
        n = plan["batches"]
        shape = (g["capacity"], list(ks), g["max_read_len"], g["batch_reads"])
        assert plan["peak"] == cli.window_peak(n, *shape)
        assert plan["peak"] <= plan["budget"] or n == 1
        if n < cli.AUTO_MAX_BATCHES:
            assert cli.window_peak(n + 1, *shape) > plan["budget"]
        assert plan["peak"] >= max(cli.window_peak(n, g["capacity"], k, g["max_read_len"],
                                                   g["batch_reads"]) for k in ks)
        assert sorted(plan["lane_rows"]) == sorted(set(ks))
        assert plan["window_rows"] == sum(plan["lane_rows"].values())
        for k, rows in plan["lane_rows"].items():
            assert rows == n * g["batch_reads"] * (g["max_read_len"] - k + 1)
        if len(ks) == 1:
            single = cli.auto_window_plan(g["mem"], g["capacity"], ks[0], g["max_read_len"],
                                          g["batch_reads"])
            assert single == plan


def test_sweep_model_seeds_narrowest_first():
    """The sweep's model, term by term at k = 15 and 41: a parent's flush beside both
    samples' tables and windows, each seed beside the parental tables still unseeded and
    the lanes already seeded (15 first), and a child flush beside every scoring table."""
    C, n, B, L = 1 << 20, 4, 1024, 160
    lanes = []
    for k in (15, 41):
        W = words_per_kmer(k)
        lanes.append((n * B * (L - k + 1), 4 * W + 4, 4 * W + 8, 4 * W + 1,
                      cli.STEP_BYTES_PER_ROW[W]))
    (S1, kt1, st1, r1, F1), (S3, kt3, st3, r3, F3) = lanes
    staged = S1 * r1 + S3 * r3
    parents = 2 * C * (kt1 + kt3) + staged + max((C + S1) * F1["flush"] + C * kt1,
                                                 (C + S3) * F3["flush"] + C * kt3)
    seed15 = 2 * C * (kt1 + kt3) + 2 * C * (F1["seed"] + st1)
    seed41 = 2 * C * kt3 + C * st1 + S1 * r1 + 2 * C * (F3["seed"] + st3)
    child = C * (st1 + st3) + staged + max((C + S1) * F1["flush"] + C * st1,
                                           (C + S1) * F1["call"],
                                           (C + S3) * F3["flush"] + C * st3,
                                           (C + S3) * F3["call"])
    want = max(parents, seed15, seed41, child)
    assert cli.window_peak(n, C, [41, 15], L, B) == cli.window_peak(n, C, [15, 41], L, B) == want
    assert cli.FLUSH_BYTES_PER_ROW == cli.STEP_BYTES_PER_ROW[2]["flush"]
    with pytest.raises(ValueError, match="one k"):
        cli.window_peak(n, C, [15, 41], L, B, passes=4, spill_rows=10_000)


def test_sweep_cli_plans_over_its_ks_and_prints_each_lane(trio, tmp_path):
    """`sweep --accum-batches auto` plans over --ks: its line names the ks, each lane's
    staging rows and the modelled peak, and each k's line its uniques."""
    _, data = trio
    paths = data["paths"]
    pattern = str(tmp_path / "k{k}.tsv")
    err = io.StringIO()
    with redirect_stderr(err):
        rc = cli.main(["sweep", "--mom", paths["mom"], "--dad", paths["dad"], "--child",
                       paths["child"], "-k", "31", "--ks", "15,41", "--max-read-len", "160",
                       "--batch-reads", "1024", "--table-capacity", str(1 << 17),
                       "--accum-batches", "auto", "--device", "cpu", "-o", pattern])
    assert rc == 0
    plan = cli.auto_window_plan(4 << 30, 1 << 17, [15, 41], 160, 1024)
    text = err.getvalue()
    assert (f"accum auto: {plan['batches']} batches/window ({plan['window_rows']} staging "
            f"rows; modelled peak {plan['peak'] / 1e9:.2f} GB") in text
    assert (f"ks 15,41, staging rows a lane k=15: {plan['lane_rows'][15]}, k=41: "
            f"{plan['lane_rows'][41]}") in text
    single = cli._accum_kwargs(argparse.Namespace(
        accum_batches="auto", device="cpu", table_capacity=1 << 17, kmer_size=31,
        max_read_len=160, batch_reads=1024, mesh=(1, 1), passes=1, spill_rows=None))
    assert single == {"accum_batches": cli.auto_window_plan(4 << 30, 1 << 17, 31, 160,
                                                            1024)["batches"]}
    for k in (15, 41):
        with open(pattern.format(k=k)) as f:
            rows = f.read().count("\n") - 1
        assert f"k={k}: {rows} candidates -> {pattern.format(k=k)} (uniques mom=" in text


@pytest.mark.parametrize("k", [33, 41, 63, 64])
def test_two_word_canonical_rows_match_window_words(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(300, cs.READ_LEN), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    hi, lo, valid = cs.window_words(codes, k)
    want = np.stack([hi[valid], lo[valid]], axis=1)
    got = cs.canonical_rows(codes, k)
    np.testing.assert_array_equal(got[cs.lex_order(got[:, 0], got[:, 1])],
                                  want[np.lexsort((want[:, 1], want[:, 0]))])


@pytest.mark.parametrize("hi_bits", [0, 2, 18, 33, 64])
def test_lex_order_sorts_like_lexsort(hi_bits):
    rng = np.random.default_rng(hi_bits)
    n = 5000
    hi = rng.integers(0, 1 << hi_bits, size=n, dtype=np.uint64) if hi_bits < 64 else \
        rng.integers(0, 1 << 63, size=n, dtype=np.uint64) << np.uint64(1)
    lo = rng.integers(0, 50, size=n, dtype=np.uint64)  # many ties
    order = cs.lex_order(hi, lo)
    want = np.lexsort((lo, hi))
    np.testing.assert_array_equal(hi[order], hi[want])
    np.testing.assert_array_equal(lo[order], lo[want])


def test_reference_refuses_what_the_host_cannot_hold(trio, monkeypatch):
    """The k-mer buffers of one sample must fit the host's share, else the phase fails
    before it starts instead of running into swap."""
    work, data = trio
    monkeypatch.setattr(cs, "host_memory", lambda: {"total": 1 << 30, "available": 1 << 20})
    with pytest.raises(AssertionError, match="refusing to run into swap"):
        cs.sweep_references(SMALL, work, (41,))


@pytest.mark.parametrize("collide", [False, True])
def test_unique_pairs_counts_each_pair_once(collide, monkeypatch):
    """Distinct (hi, lo) pairs and their counts, equal to a lexicographic count; a hash
    shared by two pairs (forced here) takes the exact fallback."""
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 1 << 18, size=20000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 40, size=20000, dtype=np.uint64)
    hi[::3], lo[::3] = hi[1::3][: len(hi[::3])], lo[1::3][: len(lo[::3])]
    if collide:  # every pair of one hi hashes alike: lo ^ (hi * M) collides across his
        lo = (hi * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(5)
        lo[::2] ^= np.uint64(1)
    keys, counts = cs.unique_pairs(hi, lo)
    rows = np.stack([hi, lo], axis=1)
    want, want_counts = np.unique(rows, axis=0, return_counts=True)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    np.testing.assert_array_equal(keys[order], want)
    np.testing.assert_array_equal(counts[order], want_counts)


@pytest.mark.parametrize("n,span", [(0, 1), (1, 1), (5000, 7), (5000, 1 << 62)])
def test_sorted_counts_equals_np_unique(n, span):
    """The one-word count (a value sort in place and its run starts) equals ``np.unique``."""
    rng = np.random.default_rng(n + span % 97)
    values = rng.integers(0, span, size=n, dtype=np.uint64)
    want, want_counts = np.unique(values, return_counts=True)
    keys, counts = cs.sorted_counts(values.copy())
    np.testing.assert_array_equal(keys, want)
    np.testing.assert_array_equal(counts, want_counts)


def test_in_sorted_is_membership():
    rng = np.random.default_rng(3)
    s = np.unique(rng.integers(0, 1000, size=300, dtype=np.uint64))
    a = rng.integers(0, 1100, size=2000, dtype=np.uint64)
    np.testing.assert_array_equal(cs._in_sorted(a, s), np.isin(a, s))
    assert not cs._in_sorted(a, s[:0]).any()


@pytest.mark.parametrize("k", [15, 41])
def test_scale_counts_on_a_shared_pool_and_buffers(trio, k, tmp_path):
    """Given one pool and shared buffers sized for the largest k (paged in once, reused by
    every k and sample), the reference equals the one with a pool and buffers of its own,
    and the buffers stay open for the next k."""
    import concurrent.futures
    import multiprocessing

    work, _ = trio
    os.makedirs(tmp_path / "own")
    os.makedirs(tmp_path / "shared")
    want = cs.scale_counts(SMALL, work, str(tmp_path / "own"), k, n_buckets=8, workers=2,
                           live=3)
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool, \
            cs.scale_slots(SMALL, (15, 41)) as slots:
        assert len(slots) == 3 and all(s.size == cs.values_bytes(SMALL, 41) for s in slots)
        got = cs.scale_counts(SMALL, work, str(tmp_path / "shared"), k, n_buckets=8,
                              pool=pool, slots=slots)
        again = cs.scale_counts(SMALL, work, str(tmp_path / "shared"), k, n_buckets=8,
                                pool=pool, slots=slots[:1])
    for out in (got, again):
        assert out["ref"] == want["ref"]
        assert out["candidates"] == want["candidates"]


def test_scale_slots_refuse_what_the_host_cannot_hold(monkeypatch):
    monkeypatch.setattr(cs, "host_memory", lambda: {"total": 1 << 30, "available": 1 << 20})
    with pytest.raises(AssertionError, match="refusing to run into swap"):
        with cs.scale_slots(SMALL, (15, 41)):
            pass


def test_scale_jobs_make_the_trio_then_the_references(tmp_path, monkeypatch):
    """The background job: phase 12's trio (BAMs, reference at k = 31) and then phase 13's
    references at k = 15, 21, 41 on one pool, equal to ``scale_trio`` and
    ``sweep_references`` run on their own; ``close`` ends the pool."""
    monkeypatch.setattr(cs, "EARLY_WORKERS", 2)
    monkeypatch.setattr(cs, "SCALE_BUCKETS", 8)
    spec = cs.ScaleSpec(genome_len=6_000, coverage=6, chunk_reads=150, seed=21)
    jobs = cs.ScaleJobs(spec, str(tmp_path / "jobs"))
    try:
        data, refs = jobs.data(), jobs.refs()
    finally:
        jobs.close()
    assert not jobs._thread.is_alive()
    assert set(jobs.ended_s) == {"data", "refs"}
    solo = str(tmp_path / "solo")
    os.makedirs(solo)
    want = cs.scale_trio(spec, solo, n_buckets=8, workers=2)
    want_refs = cs.sweep_references(spec, solo, (15, 21, 41), workers=2)
    assert data["ref"] == want["ref"] and data["candidates"] == want["candidates"]
    for sample in cs.SCALE_SAMPLES:
        with open(data["paths"][sample], "rb") as f, open(want["paths"][sample], "rb") as g:
            assert f.read() == g.read()
    assert sorted(refs) == [15, 21, 41]
    for k, r in refs.items():
        assert r["ref"] == want_refs[k]["ref"]
        assert r["candidates"] == want_refs[k]["candidates"]
