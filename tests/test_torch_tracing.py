"""The port's spans and tallies (``utils/metrics.py``) on the CPU: off unless a
``torch.profiler`` records, and then a tree of named spans inside the pipeline's layers, in
the profiler's Chrome trace as user annotations of the dispatch thread. The fixture is
tests/test_torch_pipeline.py's trio."""

import collections
import json
import threading

import numpy as np
import pytest
import torch

from denovo_kmer_tpu_torch.cohort import run_trio_multi_k
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops import fused, score, stream, table
from denovo_kmer_tpu_torch.pipeline import _trio_result, run_trio
from denovo_kmer_tpu_torch.utils import metrics as metrics_mod
from denovo_kmer_tpu_torch.utils.metrics import Metrics, span, tally

torch.set_num_threads(1)

SPEC = dict(genome_len=3000, read_len=60, coverage=8.0, seed=3,
            n_inherited_snvs=8, n_denovo_snvs=3, n_rate=0.002)
#: a small staging window, so that every sample flushes inside its stream
CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 14, accum_batches=2)
KS = (15, 21, 41)
#: the spans the table steps open: each flush sorts its staged rows once and merges them
#: into its table, the seed merges two tables, the fused call sorts once
TABLE_STEPS = ("flush", "flush_score", "seed", "call")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("trio")
    return write_trio_bams(make_trio(TrioSpec(**SPEC)), str(d))


def _run(entry, paths, m):
    """→ {k: (report, candidates, tables_n)} of one run of ``entry`` into ``m``."""
    cfg = EngineConfig(**CFG)
    if entry == "run_trio":
        res = {cfg.k: run_trio(paths["mom"], paths["dad"], paths["child"], cfg, m,
                               device="cpu")}
    else:
        res = run_trio_multi_k(paths["mom"], paths["dad"], paths["child"], cfg, KS, m,
                               device="cpu")
    return {k: (r.report, r.candidates, r.tables_n) for k, r in res.items()}


def _lanes(entry):
    return 1 if entry == "run_trio" else len(KS)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module", params=["run_trio", "run_trio_multi_k"])
def traced(request, paths):
    """(entry, results, Metrics, profiler, rows passed to the sorts: ``_sorted_groups`` and
    ``_staged_groups``) of a traced run."""
    rows = []

    def counted(real):
        def wrapped(parts):
            rows.append(sum(table._rows_shape(r)[0] for r, _v, _w in parts))
            return real(parts)
        return wrapped

    def counted_staged(real):
        def wrapped(kmers, valid):
            rows.append(kmers.shape[0])
            return real(kmers, valid)
        return wrapped

    mp = pytest.MonkeyPatch()
    for mod in (table, fused):
        mp.setattr(mod, "_sorted_groups", counted(mod._sorted_groups))
    for mod in (stream, score):
        mp.setattr(mod, "_staged_groups", counted_staged(mod._staged_groups))
    m = Metrics()
    try:
        res, prof = _profiled(lambda: _run(request.param, paths, m))
    finally:
        mp.undo()
    return request.param, res, m, prof, rows


def _parent(m, rec):
    return m.spans[rec.parent].name if rec.parent is not None else None


def _ancestors(m, rec):
    out = []
    while rec.parent is not None:
        rec = m.spans[rec.parent]
        out.append(rec.name)
    return out


@pytest.mark.parametrize("entry", ["run_trio", "run_trio_multi_k"])
def test_untraced_run_records_no_span_and_matches_a_traced_run(entry, paths, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    m = Metrics()
    got = _run(entry, paths, m)
    assert m.spans == [] and m.tallies["rows_sorted"] > 0
    monkeypatch.undo()
    m_on = Metrics()
    want, _prof = _profiled(lambda: _run(entry, paths, m_on))
    assert m_on.spans and got == want
    assert dict(m.tallies) == dict(m_on.tallies)
    assert dict(m.counters) == dict(m_on.counters)


def test_folds_hold_the_feed_wait_the_extraction_and_the_flushes(traced):
    entry, _res, m, _prof, _rows = traced
    names = collections.Counter(r.name for r in m.spans)
    assert names["fold"] == 3 and names["flush"] + names["flush_score"] >= 3
    for r in m.spans:
        if r.name == "fold":
            assert _parent(m, r) in ("build_mom", "build_dad", "build_child")
        elif r.name in ("feed_wait", "extract", "flush", "flush_score"):
            assert _parent(m, r) == "fold"
        elif r.name == "seed":
            assert _ancestors(m, r) == ["build_child"]
        elif r.name == "call":
            assert _parent(m, r) == "trio_call"
    assert {_parent(m, r) for r in m.spans
            if r.name not in ("fold", "table.sort", "table.merge")} <= {
        "fold", "build_child", "trio_call", None}
    assert {r.name for r in m.spans if _parent(m, r) == "fold"} == {
        "feed_wait", "extract", "flush", "flush_score"}
    # a feed_wait a batch, and one more a sample for the end of its stream
    assert names["feed_wait"] == m.counters["batches"] + 3
    assert names["extract"] == m.counters["batches"] * _lanes(entry)
    assert names["seed"] == names["call"] == names["report"] == _lanes(entry)


def test_every_table_step_sorts_inside_a_table_sort_span(traced):
    entry, _res, m, _prof, rows = traced
    sorts = [r for r in m.spans if r.name == "table.sort"]
    merges = [r for r in m.spans if r.name == "table.merge"]
    assert all(_parent(m, r) in TABLE_STEPS for r in sorts + merges)
    steps = collections.Counter(r.name for r in m.spans if r.name in TABLE_STEPS)
    assert steps["seed"] and steps["call"] and steps["flush"] + steps["flush_score"]
    # every step but the seed sorts once (each flush here has staged rows); every step but
    # the fused call merges once
    sorted_in = collections.Counter(m.spans[r.parent].name for r in sorts)
    merged_in = collections.Counter(m.spans[r.parent].name for r in merges)
    assert sorted_in == steps - collections.Counter(seed=steps["seed"])
    assert merged_in == steps - collections.Counter(call=steps["call"])
    assert len(sorts) == len(rows)
    assert m.tallies["rows_sorted"] == sum(rows) > 0
    assert int(m.tallies["rows_merged"]) > 0
    # device spans on the CPU read the host's clock; host spans have no device seconds
    assert all(r.device_s == r.end - r.start for r in m.spans
               if r.name in TABLE_STEPS + ("table.sort", "table.merge"))
    assert all(r.device_s is None for r in m.spans if r.name in ("fold", "report", "extract"))
    assert m.span_seconds("table.sort", device=True) == pytest.approx(
        m.span_seconds("table.sort"))


def test_spans_are_user_annotations_of_the_dispatch_thread(traced, tmp_path):
    _entry, _res, m, prof, _rows = traced
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tid = threading.get_native_id()
    assert {r.thread for r in m.spans} == {tid}
    names = {r.name for r in m.spans}
    found = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation" and e["name"] in names
                                and e.get("tid") == tid)
    assert found == collections.Counter(r.name for r in m.spans)


def test_own_seconds_leave_out_the_child_spans(traced):
    _entry, _res, m, _prof, _rows = traced
    folds = [i for i, r in enumerate(m.spans) if r.name == "fold"]
    inner = sum(r.end - r.start for r in m.spans if r.parent in folds)
    total = m.span_seconds("fold")
    assert total == pytest.approx(sum(m.spans[i].end - m.spans[i].start for i in folds))
    assert m.span_seconds("fold", own=True) == pytest.approx(total - inner)
    assert 0 < m.span_seconds("fold", own=True) < total
    assert m.span_seconds("report") > 0 and m.span_seconds("no such span") == 0


@pytest.mark.parametrize("traced_run", [False, True])
def test_summary_and_to_dict_hold_counters_and_seconds_alone(traced_run, paths):
    m = Metrics()
    if traced_run:
        _profiled(lambda: _run("run_trio", paths, m))
        assert m.spans
    else:
        _run("run_trio", paths, m)
        assert not m.spans
    plain = Metrics()
    plain.counters.update(m.counters)
    plain.seconds.update(m.seconds)
    assert m.summary() == plain.summary()
    assert m.to_dict() == plain.to_dict() == {"counters": dict(m.counters),
                                              "seconds": dict(m.seconds)}


@pytest.mark.parametrize("n", [0, 5])
def test_a_trio_result_is_one_report_span_and_tallies_its_candidates(n):
    # the span and the tally the harness's ``report`` idle label and ``report_s`` read
    cols = (np.arange(2 * n, dtype=np.uint32).reshape(n, 2),
            *(np.full(n, c, np.uint32) for c in (3, 0, 1)))
    m = Metrics()
    m.count("candidates", 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _trio_result(cols, 31, m, {})
    assert [(r.name, r.parent) for r in m.spans] == [("report", None)]
    assert m.spans[0].device_s is None and m.span_seconds("report") > 0
    assert m.counters["candidates"] == 2 + n and len(res.candidates) == n
    assert [e.count for e in prof.key_averages() if e.key == "report"] == [1]


def test_span_outside_a_call_records_nowhere_and_a_timer_binds_its_metrics():
    assert span("x") is span("y")  # no profiler: the shared no-op
    tally("rows_sorted", 5)  # no call bound: counted nowhere
    m = Metrics()
    with m.timer("outer"):
        tally("rows_sorted", 7)
    assert m.tallies["rows_sorted"] == 7 and m.seconds["outer"] > 0 and not m.spans
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("lonely"):  # record_function only: no Metrics is bound
            pass
        with m.timer("outer"):
            with span("inner"):
                pass
            with Metrics().span("other"):  # another call's span: no parent in m
                pass
    assert [(r.name, r.parent) for r in m.spans] == [("outer", None), ("inner", 0)]


def test_merge_from_keeps_each_span_s_parent():
    a, b = Metrics(), Metrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with a.span("x"):
            pass
        with b.span("p"):
            with span("q"):
                pass
    b.tallies["rows_sorted"] += 3
    a.merge_from(b)
    assert [(r.name, r.parent) for r in a.spans] == [("x", None), ("p", None), ("q", 1)]
    assert a.tallies["rows_sorted"] == 3


def test_tracing_reads_the_profiler_state():
    assert not metrics_mod.tracing()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert metrics_mod.tracing()
    assert not metrics_mod.tracing()


@pytest.mark.cuda
def test_device_spans_read_cuda_events_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.randint(0, 1 << 40, (1 << 22,), device=dev)
    m = Metrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        with m.span("sorts", dev):
            for _ in range(4):
                torch.sort(x)
    rec = m.spans[0]
    assert rec.events is not None and rec.device_s is None
    s = m.span_seconds("sorts", device=True)
    assert rec.events is None and s == rec.device_s > 0
