"""The single-decode spill's spans and tallies (``ops/spill.py``) on the CPU, on the
benchmark's reads (``gpubench/reads.py``) fed at the port's decode seam: ``run_trio_spill``
at 4 passes, each pass's scoring table filled to at least 75%, equals the plain reference
(``gpubench/reference.py``) exactly; under a profiler it records a ``spill.partition`` span
a window, ``spill.store`` spans, ``spill.fold`` spans holding the table steps, and tallies
``rows_spilled`` (the samples' valid windows) and ``rows_partitioned`` (the staged rows);
without one it records no span."""

import collections

import pytest
import torch

from denovo_kmer_tpu_torch import pipeline
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops import spill
from denovo_kmer_tpu_torch.ops.pack import PackedReads
from denovo_kmer_tpu_torch.utils.metrics import Metrics
from gpubench import harness, reads, reference

torch.set_num_threads(1)

SPEC = reads.ReadSpec(genome_len=20000, coverage=10, read_len=151, het_rate=0.001, dnms=10,
                      err_rate=0.002, n_rate=0.002, reverse_share=0.5)
SEED = 7
K = 31
PASSES = 4
#: a pass's scoring table holds 12.5-12.7K of these 16,384 rows at this seed
CFG = dict(k=K, max_read_len=160, batch_reads=256, accum_batches=2, table_capacity=1 << 14,
           tau_parent=0, min_child_count=2)
ROUTES = ("store", "host")


@pytest.fixture(scope="module")
def samples():
    return reads.make_trio(SPEC, SEED, "cpu", CFG["batch_reads"], CFG["max_read_len"], (K,),
                           PackedReads)


@pytest.fixture(scope="module")
def answer():
    haps = reads.haplotypes(SPEC, SEED, "cpu")
    return reference.trio_answer(lambda s: reads.sample_chunks(SPEC, SEED, s, haps[s]), K,
                                 True, CFG["max_read_len"], CFG["tau_parent"],
                                 CFG["min_child_count"])


def _spill(samples, route, traced, tmp_path):
    """One traced or untraced ``run_trio_spill`` → (TrioResult, Metrics, each pass's scoring
    table fill)."""
    cfg = EngineConfig(**CFG)
    source = harness.ReadSource(samples, cfg.batch_reads,
                                reads.padded_length(cfg.max_read_len) // 16)
    m = source.metrics = Metrics()
    mp = pytest.MonkeyPatch()
    if route == "store":
        where = {"device_store_rows": reads.spill_rows(samples, K, PASSES, 1.10)}
    else:  # the benchmark's reads have no file for the spill's manifest to sign
        where = {"spill_dir": str(tmp_path / "spill")}
        mp.setattr(spill, "source_signature", lambda path, *_a: {"path": path})
    fills = []
    real = pipeline.call_from_score

    def call_from_score(stab, *a):
        fills.append(int(stab.n))
        return real(stab, *a)

    mp.setattr(pipeline, "call_from_score", call_from_score)
    profiler = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
                if traced else None)
    try:
        with harness.seam_bound(source):
            paths = source.paths()
            if profiler is not None:
                profiler.__enter__()
            try:
                res = pipeline.run_trio_spill(paths["mom"], paths["dad"], paths["child"], cfg,
                                              PASSES, metrics=m, device="cpu", **where)
            finally:
                if profiler is not None:
                    profiler.__exit__(None, None, None)
        source.check()
    finally:
        mp.undo()
    return res, m, fills


@pytest.fixture(scope="module", params=[(r, t) for r in ROUTES for t in (False, True)],
                ids=lambda p: f"{p[0]}-{'traced' if p[1] else 'untraced'}")
def spilled(request, samples, tmp_path_factory):
    route, traced = request.param
    res, m, fills = _spill(samples, route, traced, tmp_path_factory.mktemp(route))
    return route, traced, res, m, fills


@pytest.fixture(scope="module", params=ROUTES)
def traced(request, samples, tmp_path_factory):
    """(route, Metrics) of a traced run."""
    _res, m, _fills = _spill(samples, request.param, True,
                             tmp_path_factory.mktemp(request.param))
    return request.param, m


def _parent(m, rec):
    return m.spans[rec.parent].name if rec.parent is not None else None


def test_the_spill_equals_the_reference_with_every_pass_table_three_quarters_full(
        spilled, answer):
    _route, _traced, res, _m, fills = spilled
    C = CFG["table_capacity"]
    assert len(fills) == PASSES and all(0.75 * C <= n <= C for n in fills), fills
    assert res.report == answer.report()
    assert res.candidates == answer.rows()
    assert {s: int(n) for s, n in res.tables_n.items()} == answer.tables_n


def test_the_tallies_count_the_valid_windows_and_the_staged_rows(spilled, samples):
    _route, _traced, _res, m, _fills = spilled
    assert m.tallies["rows_spilled"] == sum(s.valid_windows[K] for s in samples)
    assert m.tallies["rows_partitioned"] == m.counters["windows_staged"] > 0


def test_spans_are_recorded_only_under_a_profiler(spilled):
    _route, traced, _res, m, _fills = spilled
    names = {r.name for r in m.spans}
    if not traced:
        assert names == set()
    else:
        assert {"spill.partition", "spill.fold", "flush", "flush_score"} <= names


@pytest.mark.parametrize("name,parents", [
    ("spill.partition", {"fold"}),
    ("spill.store", {"fold"}),
    ("spill.fold", {"count_passes"}),
    ("flush", {"spill.fold"}),
    ("flush_score", {"spill.fold"}),
])
def test_each_spill_span_sits_in_its_layer(traced, samples, name, parents):
    route, m = traced
    found = [r for r in m.spans if r.name == name]
    if name == "spill.store" and route == "host":
        assert found == []  # the host spill writes files, not a store
        return
    assert found and {_parent(m, r) for r in found} == parents
    # a window a flush of the fold loop: every accum_batches batches, and the rest
    windows = sum(-(-len(s.batches) // CFG["accum_batches"]) for s in samples)
    count = collections.Counter(r.name for r in m.spans)[name]
    if name in ("spill.partition", "spill.store"):
        assert count == windows
    elif name == "spill.fold":  # mom's, dad's and the child's fold, a pass each
        assert count == 3 * PASSES
