"""The port's own spans in a traced CPU run against the harness's instruments (``probes``,
``trace``): each port span of a name ``trace.SPANS`` reads sits directly inside the harness
span of that name, the port's table steps and calls are the ones the probe clocks, and the
readers of the port's spans and tallies find numbers only in a traced run."""

import json
import os

import pytest

from gpubench import harness, probes, trace
from gpubench.tests.conftest import tiny_cell

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
PORT_METRICS = ("table_sort_device_s", "rows_sorted_G", "fold_self_s", "report_s")
#: the harness's spans around the port's functions (the window and the trio have no twin)
WRAPPED = tuple(s for s in trace.SPANS if s not in (trace.WINDOW, "trio"))
ENTRIES = [("pipeline.run_trio", ("-k", "31")),
           ("cohort.run_trio_multi_k", ("--ks", "15,21,31,41"))]


def _cell(entry, flags):
    cell = tiny_cell(entry, flags)
    cell.metrics = [m for m in BENCH["per_layer"] if m["name"] in PORT_METRICS]
    return cell


@pytest.fixture(scope="module", params=ENTRIES, ids=[e for e, _f in ENTRIES])
def traced_run(request):
    """A traced CPU run of a tiny cell → (result, its Probe, the window's trios, the trace's
    events)."""
    seen = {}

    class KeptProbe(probes.Probe):
        def __init__(self, device):
            super().__init__(device)
            seen["probe"] = self

    real_window, real_summarize = harness.window, trace.summarize

    def window(*a, **kw):
        seen["trios"], seconds = real_window(*a, **kw)
        return seen["trios"], seconds

    def summarize(events):
        seen["events"] = events
        return real_summarize(events)

    mp = pytest.MonkeyPatch()
    mp.setattr(probes, "Probe", KeptProbe)
    mp.setattr(harness, "window", window)
    mp.setattr(trace, "summarize", summarize)
    try:
        out = harness.run_cell(_cell(*request.param), 2**31 + 91, 0.5, True, "cpu")
    finally:
        mp.undo()
    assert out["correct"]
    return out, seen["probe"], seen["trios"], seen["events"]


def _port_spans(trios, names):
    return [r for t in trios for r in t.metrics.spans if r.name in names]


def _annotation_parents(events):
    """(name, the name of the innermost user annotation holding it) of each user annotation
    on the window's thread, by start."""
    window = next(e for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == trace.WINDOW)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("tid") == window["tid"]), key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for a, b, name in spans:
        while stack and not (stack[-1][0] <= a and b <= stack[-1][1]):
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def test_each_port_span_sits_directly_inside_the_harness_span_of_its_name(traced_run):
    _out, _probe, trios, events = traced_run
    pairs = _annotation_parents(events)
    for name in WRAPPED:
        port = len(_port_spans(trios, {name}))
        inner = sum(1 for n, parent in pairs if n == name and parent == name)
        outer = sum(1 for n, parent in pairs if n == name and parent != name)
        assert port == inner == outer, (name, port, inner, outer)
    assert len(_port_spans(trios, {"fold", "extract", "report"})) > 0


def test_the_port_steps_are_the_ones_the_probe_clocks(traced_run):
    _out, probe, trios, _events = traced_run
    steps = _port_spans(trios, {"flush", "flush_score", "seed"})
    calls = _port_spans(trios, {"call"})
    assert len(steps) == len(probe.table) > 0 and len(calls) == len(probe.calls) > 0
    # on the CPU a device span reads the host's clock, inside the probe's clock
    port_s = sum(r.device_s for r in steps)
    assert 0 < port_s <= probe.table_s
    assert 0 < sum(r.device_s for r in calls) <= probe.call_s


def test_the_readers_of_the_port_spans_report_in_a_traced_run(traced_run):
    out, _probe, trios, _events = traced_run
    got = {name: out["metrics"][name]["value"] for name in PORT_METRICS}
    assert all(v > 0 for v in got.values()), got
    rows = sum(t.metrics.tallies["rows_sorted"] for t in trios) / len(trios)
    assert got["rows_sorted_G"] == pytest.approx(rows / 1e9)
    assert out["metrics"]["rows_sorted_G"]["unit"] == "Grows"


def test_the_readers_of_the_port_spans_find_nothing_in_an_untraced_run():
    out = harness.run_cell(_cell(*ENTRIES[0]), 2**31 + 92, 0.2, False, "cpu")
    assert out["correct"] and out["metrics"] == {}
