"""The spill cell (``spill4_k31_chr20_packed``): its files, its four per-layer metrics on
tiny CPU runs of its route (found in a traced run, None in an untraced one and on a port
without the spill's spans), and two faults of the spill that make a run not correct."""

import json
import os
import types

import pytest
import torch

from gpubench import harness, spill_work
from gpubench.tests.conftest import tiny_cell

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
CELL = "spill4_k31_chr20_packed"
NEW = ("partition_device_s", "partition_roofline", "store_fold_device_s", "rows_spilled_G")
#: the metrics of the other cells that the spill's steps also feed; the table steps' probes
#: (``table_device_s``, ``flush_roofline``) do not see the folds from the store
SHARED = ("feed_wait_s", "extract_roofline", "call_device_s", "peak_device_GB",
          "device_idle_pct", "table_sort_device_s", "rows_sorted_G", "fold_self_s", "report_s")
#: the cell's route at the tiny reads' size: a pass's scoring table ≈ 77% full
ROUTE = {"table_capacity": 1 << 14, "passes": 4, "spill_slack": 1.1}


def _tiny(metrics=NEW):
    cell = tiny_cell("pipeline.run_trio_spill", ("-k", "31"), ROUTE)
    cell.metrics = [m for m in BENCH["per_layer"] if m["name"] in metrics]
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_finds_its_files(trace):
    cell = harness.load_cell(CELL, trace)
    got = {m["name"] for m in cell.metrics}
    assert got == (set(NEW + SHARED) if trace else {"trio_reads_per_s", "setup_s"})
    assert all(callable(harness.metric_reader(n)) for n in got)
    call = harness.load_cell("call_k31_chr20_packed", trace)
    assert cell.config["entry"] == "pipeline.run_trio_spill"
    assert cell.config["flags"] == call.config["flags"]
    assert cell.traffic["reads"] == call.traffic["reads"]
    route = cell.traffic["route"]
    assert route == {"table_capacity": 1 << 26, "passes": 4, "spill_slack": 1.10}
    assert (cell.config["table_capacity"], cell.config["passes"]) == (
        route["table_capacity"], route["passes"])
    args = harness.engine_args(cell.config, cell.traffic, "cpu", 1 << 20)
    assert (args.passes, args.spill_rows, args.table_capacity) == (4, 1 << 20, 1 << 26)


@pytest.fixture(scope="module")
def traced():
    """A traced tiny run of the route → (result, the reads made)."""
    seen = {}
    real = harness.make_reads

    def make_reads(*a, **kw):
        seen["samples"] = real(*a, **kw)
        return seen["samples"]

    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "make_reads", make_reads)
    try:
        out = harness.run_cell(_tiny(), 2**31 + 93, 0.5, True, "cpu")
    finally:
        mp.undo()
    assert out["correct"] and all(v == [0, 0] for v in out["check"].values())
    return out, seen["samples"]


@pytest.mark.parametrize("name", NEW)
def test_each_metric_reads_a_traced_run(traced, name):
    out, _samples = traced
    assert out["metrics"][name]["value"] > 0
    assert out["metrics"][name]["unit"] == next(
        m["unit"] for m in BENCH["per_layer"] if m["name"] == name)


def test_rows_spilled_are_the_reads_valid_windows(traced):
    out, samples = traced
    valid = sum(s.valid_windows[31] for s in samples)
    assert out["metrics"]["rows_spilled_G"]["value"] == valid / 1e9


def test_the_metrics_read_none_untraced():
    out = harness.run_cell(_tiny(), 2**31 + 94, 0.2, False, "cpu")
    assert out["correct"] and out["metrics"] == {}


def test_the_metrics_read_none_on_a_port_without_the_spill_spans():
    """The parent port's traced run: spans and tallies, none of the spill's."""
    from denovo_kmer_tpu_torch.utils.metrics import Metrics, SpanRecord

    m = Metrics()
    m.spans.append(SpanRecord("fold", 0.0, 1.0, None, 0, device_s=1.0))
    m.tallies["rows_sorted"] += 10
    run = types.SimpleNamespace(trios=[types.SimpleNamespace(metrics=m, results={31: None})])
    assert all(harness.metric_reader(n)(run) is None for n in NEW)
    assert not spill_work.spilled(run)


def test_partition_bytes_read_each_staged_row_and_write_each_spilled_row():
    # W = 2: a staged row 8 B of key words and a flag byte; a spilled row 8 B
    assert spill_work.partition_bytes(10, 7, 2) == 10 * 9 + 7 * 8
    assert spill_work.partition_bytes(10, 7, 3) == 10 * 13 + 7 * 12


def _misrouted(spill, monkeypatch):
    """The partition sends the last row of pass 0's block to pass 1."""
    real = spill.partition_window

    def partition_window(acc, n_passes, capacity):
        disp, counts, ovf, acc = real(acc, n_passes, capacity)
        disp, counts = disp.clone(), counts.clone()
        c0, c1 = int(counts[0]), int(counts[1])
        disp[1, c1] = disp[0, c0 - 1]
        counts[0] -= 1
        counts[1] += 1
        return disp, counts, ovf, acc

    monkeypatch.setattr(spill, "partition_window", partition_window)


def _write_one_row_late(spill, monkeypatch):
    """``store_append`` writes pass 0's block one row past its fill: the block's last row is
    dropped, and the slot at the fill keeps the store's zeros (the all-A k-mer)."""
    real = spill.store_append

    def store_append(store, disp, counts):
        c = int(torch.as_tensor(counts)[0])
        out = real(store, disp, counts)
        at = store.fill[0]
        if c:
            out.rows[0, at + 1:at + c] = disp[0, :c - 1].clone()
            out.rows[0, at] = 0
        return out

    monkeypatch.setattr(spill, "store_append", store_append)


@pytest.mark.parametrize("fault", [_misrouted, _write_one_row_late])
def test_a_broken_spill_makes_the_run_not_correct(monkeypatch, fault):
    from denovo_kmer_tpu_torch.ops import spill

    fault(spill, monkeypatch)
    out = harness.run_cell(_tiny(()), 5, 0.2, False, "cpu")
    assert out["correct"] is False and out["failed"] == out["attempted"] >= 1
    assert all(out["check"][f"k31_{s}_n_off"][0] > 0 for s in ("mom", "dad", "child"))
