"""The real-size phase of chip_smoke.py (phase 12) and the port's repairs for it, on the CPU
at a small size: the vectorized fixed-layout BAM writer against io/bam.BamWriter (through
io/bam.py and the C++ feeder's packed batches), the hash-bucketed numpy reference against
``reference_counts``, the phase's trio generator through the JAX package's ``run_trio``,
the port's ``run_trio`` and its 4-pass device-store spill (byte-equal reports), the
``--accum-batches auto`` plan as a pure function of memory and shapes, the flush at a
capacity far above its window, and the release of the parental tables while the child
streams."""

import argparse
import gc
import io
import os
import sys
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops import fused as jfused
from denovo_kmer_tpu.ops import score as jscore
from denovo_kmer_tpu.ops import stream as jstream
from denovo_kmer_tpu.ops import table as jtable
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu_torch import cli, pipeline
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io import native
from denovo_kmer_tpu_torch.io.bam import BamRecord, BamWriter, read_bam_records
from denovo_kmer_tpu_torch.io.bgzf import BGZF_EOF
from denovo_kmer_tpu_torch.ops import fused as tfused
from denovo_kmer_tpu_torch.ops import score as tscore
from denovo_kmer_tpu_torch.ops import stream as tstream
from denovo_kmer_tpu_torch.ops import table as ttable
from denovo_kmer_tpu_torch.ops.pack import pack_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (the smoke script's fixtures)

torch.set_num_threads(1)

# phase 12's rates on a small genome: ~50 kbp at 12x
SMALL = cs.ScaleSpec(genome_len=50_000, coverage=12, chunk_reads=1000, seed=5)
CFG = dict(k=31, max_read_len=160, batch_reads=1024, accum_batches=2,
           table_capacity=1 << 17)
PASSES = 4


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """Phase 12's generator and writer on SMALL, with its reference at k = 31."""
    work = str(tmp_path_factory.mktemp("scale"))
    return work, cs.scale_trio(SMALL, work, k=31, n_buckets=8, workers=2)


def _sample_codes(spec, work, sample):
    return np.concatenate([cs.scale_chunk(spec, work, sample, c)[2]
                           for c in range(spec.chunks)])


def test_generator_plants_inherited_and_de_novo_variants(trio):
    work, data = trio
    haps = {(s, h): np.load(cs._hap_path(work, s, h)) for s in cs.SCALE_SAMPLES
            for h in (0, 1)}
    het = (haps["mom", 0] != haps["mom", 1]).mean()
    assert 1e-3 < het < 3e-3  # two independent haplotypes at 1e-3 each
    np.testing.assert_array_equal(haps["child", 1], haps["dad", 0])
    diff = np.nonzero(haps["child", 0] != haps["mom", 0])[0]
    np.testing.assert_array_equal(diff, data["dnms"])
    assert len(diff) == SMALL.dnms
    for s in ("mom", "dad"):  # no parental haplotype varies at a de novo site
        for h in (0, 1):
            assert (haps[s, h][diff] == haps["mom", 0][diff]).all()
    pos, rev, codes = cs.scale_chunk(SMALL, work, "child", 0)
    assert codes.shape == (SMALL.chunk_reads, cs.READ_LEN)
    assert 0.3 < rev.mean() < 0.7 and (codes == 4).any()
    assert pos.max() <= SMALL.genome_len - cs.READ_LEN


def test_vectorized_bam_writer_matches_bam_writer(trio, tmp_path):
    """The fixed-layout writer's BAM decodes to the records io/bam.BamWriter writes of the
    same reads, through io/bam.py and through the C++ feeder's packed batches."""
    work, data = trio
    digits = len(str(SMALL.reads - 1))
    want = tmp_path / "want.bam"
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    with open(want, "wb") as f, BamWriter(f, references=[(SMALL.ref_name, SMALL.genome_len)],
                                          level=1) as w:
        for c in range(SMALL.chunks):
            pos, rev, codes = cs.scale_chunk(SMALL, work, "mom", c)
            for i in range(codes.shape[0]):
                index = c * SMALL.chunk_reads + i
                w.write(BamRecord(name=f"m{index:0{digits}d}", flag=0x10 if rev[i] else 0,
                                  refid=0, pos=int(pos[i]), mapq=60,
                                  cigar=((cs.READ_LEN, 0),),
                                  seq=alphabet[codes[i]].tobytes().decode()))
    got = list(read_bam_records(data["paths"]["mom"]))
    assert got == list(read_bam_records(str(want)))
    assert len(got) == SMALL.reads
    with open(data["paths"]["mom"], "rb") as f:
        assert f.read()[-len(BGZF_EOF):] == BGZF_EOF
    cfg = EngineConfig(**CFG)
    py = list(pack_records(read_bam_records(str(want)), cfg))
    if not native.native_available():
        pytest.skip("the port's native feeder did not build here (no g++)")
    with native.NativeBamFeeder(data["paths"]["mom"], cfg) as feeder:
        fed = list(feeder)
    assert len(fed) == len(py) > 1
    for a, b in zip(fed, py):
        assert a.n_reads == b.n_reads
        for field in ("words", "vwords", "length"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("k", [31, 41])
def test_bucketed_reference_matches_reference_counts(k, tmp_path):
    spec = cs.ScaleSpec(genome_len=12_000, coverage=8, chunk_reads=200, seed=k)
    data = cs.scale_trio(spec, str(tmp_path), k=k, n_buckets=4, workers=2)
    ref = {}
    for sample in cs.SCALE_SAMPLES:
        keys, counts, windows = cs.reference_counts(_sample_codes(spec, str(tmp_path), sample),
                                                    k)
        got_keys, got_counts = cs.scale_reference_table(str(tmp_path), sample, n_buckets=4)
        np.testing.assert_array_equal(got_keys.reshape(keys.shape), keys)
        np.testing.assert_array_equal(got_counts, counts)
        assert data["ref"][sample] == {"n": len(counts), "windows": windows}
        ref[sample] = (keys, counts, windows)
    assert data["candidates"] == cs.reference_candidates(ref, EngineConfig(k=k))
    assert len(data["candidates"]) > 0


@pytest.mark.parametrize("k", [21, 31, 32])
def test_canonical_rows_match_window_words(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(300, cs.READ_LEN), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    _, lo, valid = cs.window_words(codes, k)
    np.testing.assert_array_equal(np.sort(cs.canonical_rows(codes, k)[:, 0]),
                                  np.sort(lo[valid]))


def test_port_run_trio_and_spill_match_jax_on_the_scale_trio(trio):
    _, data = trio
    paths = data["paths"]
    want = jax_run_trio(paths["mom"], paths["dad"], paths["child"], JaxConfig(**CFG))
    cfg = EngineConfig(**CFG)
    got = pipeline.run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cpu")
    assert got.report == want.report
    assert got.tables_n == want.tables_n
    assert got.report == cs.report_text(data["candidates"], 31)
    assert got.tables_n == {s: r["n"] for s, r in data["ref"].items()}
    rows = -(-int(cs.SCALE_SPILL_SLACK * max(r["windows"] for r in data["ref"].values()))
             // PASSES)
    spill = pipeline.run_trio_spill(paths["mom"], paths["dad"], paths["child"], cfg, PASSES,
                                    device_store_rows=rows, device="cpu")
    assert spill.report == want.report
    assert spill.tables_n == want.tables_n


GRID = [dict(mem=m, capacity=c, k=k, max_read_len=160, batch_reads=b)
        for m in (16 << 30, 85_017_493_504) for c in (1 << 20, 1 << 23, 1 << 26, 1 << 28)
        for k in (15, 31, 41) for b in (4096, 16384)]


@pytest.mark.parametrize("mesh,passes,spill_rows",
                         [((1, 1), 1, None), ((2, 4), 1, None), ((1, 1), 4, 413_000_000),
                          ((1, 1), 4, 10_000_000)])
def test_auto_window_plan_is_the_largest_window_within_the_budget(mesh, passes, spill_rows):
    """The plan's modelled peak fits the budget (or the window is one batch), and one more
    batch would not fit: a pure function of memory, capacity, k and batch size."""
    for g in GRID:
        kw = dict(mesh=mesh, passes=passes, spill_rows=spill_rows)
        plan = cli.auto_window_plan(**g, **kw)
        n = plan["batches"]
        assert 1 <= n <= cli.AUTO_MAX_BATCHES
        assert plan["budget"] == int(g["mem"] * cli.AUTO_MEMORY_SHARE)
        assert plan["peak"] <= plan["budget"] or n == 1
        if n < cli.AUTO_MAX_BATCHES:
            assert cli.window_peak(n + 1, g["capacity"], g["k"], g["max_read_len"],
                                   g["batch_reads"], **kw) > plan["budget"]
        assert plan["peak"] == cli.window_peak(n, g["capacity"], g["k"], g["max_read_len"],
                                               g["batch_reads"], **kw)


def test_auto_window_counts_the_flush_and_the_tables():
    """At the H100's memory and table capacity 2^28 (k = 31, 16,384 reads a batch) the
    plan's peak counts each flush row and the resident tables; at 2^29 the tables alone
    exceed the budget and the window is one batch."""
    mem = 85_017_493_504
    plan = cli.auto_window_plan(mem, 1 << 28, 31, 160, 16384)
    S, C = plan["window_rows"], 1 << 28
    assert plan["peak"] >= (C + S) * cli.FLUSH_BYTES_PER_ROW + 3 * C * 12
    assert plan["peak"] <= plan["budget"]
    assert cli.auto_window_plan(mem, 1 << 29, 31, 160, 16384)["batches"] == 1
    spill = cli.auto_window_plan(mem, 1 << 26, 31, 160, 16384, passes=4,
                                 spill_rows=413_000_000)
    assert spill["peak"] >= 3 * 4 * 413_000_000 * 8  # three samples' stores


def test_accum_auto_line_says_what_it_budgeted(capsys):
    args = argparse.Namespace(accum_batches="auto", device="cpu", table_capacity=1 << 20,
                              kmer_size=31, max_read_len=160, batch_reads=1024, mesh=(1, 1),
                              passes=1, spill_rows=None)
    got = cli._accum_kwargs(args)
    plan = cli.auto_window_plan(4 << 30, 1 << 20, 31, 160, 1024)
    assert got == {"accum_batches": plan["batches"]}
    err = capsys.readouterr().err
    assert err.startswith(f"accum auto: {plan['batches']} batches/window "
                          f"({plan['window_rows']} staging rows; modelled peak")
    assert "table capacity 1048576" in err
    assert cli._accum_kwargs(argparse.Namespace(accum_batches="3")) == {"accum_batches": 3}


K_OF_W = {1: 15, 2: 31, 3: 33, 4: 63}


def _keys(rng, n, W, pool):
    uni = rng.integers(0, 2**32, size=(pool, W), dtype=np.uint32)
    top = 2 * K_OF_W[W] - 32 * (W - 1)
    if top < 32:
        uni[:, 0] &= np.uint32((1 << top) - 1)
    return uni[rng.integers(0, pool, size=n)]


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_flush_at_a_capacity_far_above_the_window_matches_jax(W):
    """A table of capacity 2^14 holding a few hundred rows, a 64-row window (some rows
    invalid, the fill short of the buffer): flush, flush_score (growing the capacity) and
    the fused call equal the JAX package's."""
    rng = np.random.default_rng(40 + W)
    C, S, fill = 1 << 14, 64, 50
    jt = jtable.build_table(jnp.asarray(_keys(rng, 300, W, 120)), jnp.ones((300,), bool), C)
    tt = ttable.table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts), int(jt.n), "cpu")
    staged = np.concatenate([np.asarray(jt.keys)[:20], _keys(rng, S - 20, W, 40)])
    valid = rng.random(S) < 0.8
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.asarray(valid), jnp.int32(fill))

    def tacc():
        return tstream.KmerAccumulator(torch.from_numpy(staged.view(np.int32)).clone(),
                                       torch.from_numpy(valid), fill)

    _, jout = jstream.flush(jacc, jt)
    _, tout = tstream.flush(tacc(), tt)
    keys, counts, n = ttable.table_to_numpy(tout)
    np.testing.assert_array_equal(keys, np.asarray(jout.keys))
    np.testing.assert_array_equal(counts, np.asarray(jout.counts))
    assert n == int(jout.n) < 400

    jseed = jscore.seed_score_table(jt, jt, C)
    tseed = tscore.seed_score_table(tt, tt, C)
    _, jsc = jscore.flush_score(jacc, jseed, out_capacity=2 * C)
    _, tsc = tscore.flush_score(tacc(), tseed, out_capacity=2 * C)
    for got, want in zip(tscore.score_table_to_numpy(tsc)[:3], (jsc.keys, jsc.counts,
                                                                jsc.pcounts)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert int(tsc.n) == int(jsc.n)
    if (2 * K_OF_W[W]) % 32:
        want = jfused.fused_call_full(jacc, jsc, 1, 1)
        got = tfused.fused_call_full(tacc(), tsc, 1, 1)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[4:] == tuple(int(x) for x in want[4:])


def test_score_child_releases_the_parental_tables(trio, monkeypatch):
    """Once the scoring table is seeded nothing holds mom's or dad's table: the child
    streams with neither on the device, and run_trio's report is unchanged."""
    _, data = trio
    paths = data["paths"]
    refs, checked = [], []
    real_parents, real_fold = pipeline._parent_tables, pipeline._fold_placed

    def parents(*a, **kw):
        tables = real_parents(*a, **kw)
        refs.extend(weakref.ref(t.keys) for t in tables.values())
        return tables

    def fold(batches, cfg, dev, lanes, m, bucketed=False):
        if type(lanes[0].state) is tuple:  # the child's lane: (scoring table, flushed)
            gc.collect()
            checked.append([r() is None for r in refs])
        return real_fold(batches, cfg, dev, lanes, m, bucketed)

    monkeypatch.setattr(pipeline, "_parent_tables", parents)
    monkeypatch.setattr(pipeline, "_fold_placed", fold)
    cfg = EngineConfig(**CFG)
    got = pipeline.run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cpu")
    assert checked == [[True, True]]
    assert got.report == cs.report_text(data["candidates"], 31)
    tables = {"mom": ttable.empty_table(8, 2, "cpu"), "dad": ttable.empty_table(8, 2, "cpu")}
    monkeypatch.setattr(pipeline, "_fold_placed", real_fold)
    pipeline.score_child(cfg, torch.device("cpu"), tables, paths["child"],
                         pipeline.Metrics())
    assert tables == {}


def test_report_text_matches_format_report_np():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint32)
    words[:, 0] &= np.uint32((1 << 30) - 1)
    order = np.lexsort(words.T[::-1])
    words = words[order]
    cc = rng.integers(2, 40, 50).astype(np.uint32)
    cands = [((int(w[0]) << 32) | int(w[1]), int(c), 0, 0) for w, c in zip(words, cc)]
    zero = np.zeros(50, np.uint32)
    assert cs.report_text(cands, 31) == pipeline.format_report_np(words, cc, zero, zero, 31)
    buf = io.StringIO(cs.report_text([], 31))
    assert buf.read() == "#kmer\tchild_count\tmom_count\tdad_count\n"


def test_call_lane_seed_keeps_only_its_tight_capacity():
    """The scoring table is seeded over both parents' capacities and cut to the next power
    of two of the union: the cut is a copy, so the full-size seed's storage is freed."""
    rng = np.random.default_rng(8)
    cfg = EngineConfig(k=31, max_read_len=64, batch_reads=8, accum_batches=1,
                       table_capacity=1 << 12)
    W = cfg.words
    tabs = []
    for _ in range(2):
        keys = _keys(rng, 1500, W, 1500)
        jt = jtable.build_table(jnp.asarray(keys), jnp.ones((1500,), bool), 1 << 12)
        tabs.append(ttable.table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts),
                                            int(jt.n), "cpu"))
    lane = pipeline.ScoringTableBuilder(cfg, "cpu").call_lane(*tabs)
    seed, flushed = lane.state
    n = int(seed.n)
    cap = 1 << (n - 1).bit_length()
    assert not flushed and 1024 <= cap < 2 << 12 and seed.capacity == cap
    for t in (seed.keys, seed.counts, seed.pcounts):
        assert t.untyped_storage().nbytes() == t.numel() * 4
    want = jscore.seed_score_table(
        *[jtable.KmerTable(jnp.asarray(t.keys.numpy().astype(np.uint32)),
                           jnp.asarray(t.counts.numpy().astype(np.uint32)), jnp.int32(int(t.n)))
          for t in tabs], 2 << 12)
    np.testing.assert_array_equal(seed.keys.numpy().astype(np.uint32),
                                  np.asarray(want.keys)[:cap])


def test_dnm_evidence_gives_the_reference_counts_over_a_site(trio):
    """Each planted site's child k-mers: found by ``dnm_evidence`` in the bucket files with
    the reference's counts; a site under no candidate has no child-only k-mer seen twice."""
    work, data = trio
    tables = {s: cs.scale_reference_table(work, s, n_buckets=8) for s in cs.SCALE_SAMPLES}
    missed = set(cs.snvs_missed(data["candidates"], data["child_hap"], data["dnms"]))
    for site in data["dnms"][:12]:
        ev = cs.dnm_evidence(work, data["child_hap"], int(site), n_buckets=8)
        rows = cs.canonical_rows(data["child_hap"][site - 30:site + 31][None, :], 31)
        for sample, (keys, counts) in tables.items():
            at = np.searchsorted(keys[:, 0], rows[:, 0])
            at = np.minimum(at, len(keys) - 1)
            want = np.where(keys[at, 0] == rows[:, 0], counts[at], 0)
            assert ev[sample] == want.tolist()
        child_only = [c >= 2 and m == 0 and d == 0
                      for c, m, d in zip(ev["child"], ev["mom"], ev["dad"])]
        assert any(child_only) == (int(site) not in missed)


def test_spill_passes_release_their_tables(trio, monkeypatch):
    """The device-store spill's counting passes: the parents' pass tables are released once
    the pass's scoring table is seeded, and each pass's tables before the next pass folds."""
    from denovo_kmer_tpu_torch.ops import spill as tspill

    _, data = trio
    paths = data["paths"]
    seeded, called, checks = [], [], []
    real_seed, real_call = pipeline.seed_score_table, pipeline.call_from_score
    real_count, real_score = tspill.count_pass_from_store, tspill.score_pass_from_store

    def dead(refs):
        gc.collect()
        return all(r() is None for r in refs)

    def seed(mom, dad, capacity):
        seeded.append([weakref.ref(mom.keys), weakref.ref(dad.keys)])
        return real_seed(mom, dad, capacity)

    def call(tab, tau_parent, min_child_count):
        called.append([weakref.ref(tab.keys)])
        return real_call(tab, tau_parent, min_child_count)

    def count(store, pass_id, table, chunk_rows):
        if pass_id:
            checks.append(("previous pass", dead(seeded[pass_id - 1] + called[pass_id - 1])))
        return real_count(store, pass_id, table, chunk_rows)

    def score(store, pass_id, stab, chunk_rows):
        checks.append(("parents after the seed", dead(seeded[pass_id])))
        return real_score(store, pass_id, stab, chunk_rows)

    monkeypatch.setattr(pipeline, "seed_score_table", seed)
    monkeypatch.setattr(pipeline, "call_from_score", call)
    monkeypatch.setattr(tspill, "count_pass_from_store", count)
    monkeypatch.setattr(tspill, "score_pass_from_store", score)
    rows = -(-int(cs.SCALE_SPILL_SLACK * max(r["windows"] for r in data["ref"].values()))
             // PASSES)
    got = pipeline.run_trio_spill(paths["mom"], paths["dad"], paths["child"],
                                  EngineConfig(**CFG), PASSES, device_store_rows=rows,
                                  device="cpu")
    assert got.report == cs.report_text(data["candidates"], 31)
    assert len(seeded) == PASSES
    assert checks and all(ok for _what, ok in checks), checks
    assert sum(what == "previous pass" for what, _ok in checks) == 2 * (PASSES - 1)
