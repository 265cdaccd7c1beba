"""The window's rule, the feed seam, and whole runs of tiny cells on the CPU."""

import types

import pytest

from gpubench import harness
from gpubench.tests.conftest import tiny_cell


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("trio_s,seconds,want", [
    ((3.0, 3.0, 3.0, 3.0, 3.0), 10.0, 3),  # 3 + 3 + 3 = 9; a fourth would end at 12
    ((3.0, 3.0, 3.0, 3.0), 9.0, 3),  # a trio that ends on the limit still fits
    ((12.0,), 10.0, 1),  # at least one trio, however long
    ((2.0, 5.0, 1.0, 1.0), 8.0, 2),  # the last trio's time predicts the next one's
])
def test_window_runs_whole_trios_while_the_next_fits(monkeypatch, trio_s, seconds, want):
    clock = FakeClock()
    times = iter(trio_s)

    def fake_trio(*_a):
        s = next(times)
        clock.t += s
        return harness.Trio(s, 30, types.SimpleNamespace(seconds={}), {}, 0)

    monkeypatch.setattr(harness.time, "perf_counter", clock)
    monkeypatch.setattr(harness, "run_trio", fake_trio)
    trios, window_s = harness.window(None, None, None, None, "cpu", seconds)
    assert len(trios) == want
    assert window_s == sum(trio_s[:want])


def _samples():
    from denovo_kmer_tpu_torch.ops.pack import PackedReads

    from gpubench import reads

    spec = reads.ReadSpec(genome_len=3000, coverage=4, read_len=151, het_rate=0.0, dnms=2,
                          err_rate=0.0, n_rate=0.0, reverse_share=0.5)
    return reads.make_trio(spec, 1, "cpu", 64, 160, (), PackedReads)


def test_seam_is_bound_for_the_run_then_restored_and_refuses_other_paths():
    from denovo_kmer_tpu_torch import cohort, pipeline
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    real = pipeline.packed_batches
    source = harness.ReadSource(_samples(), 64, 10)
    source.metrics = Metrics()
    cfg = EngineConfig(k=31, batch_reads=64, max_read_len=160)
    with harness.seam_bound(source):
        assert pipeline.packed_batches is source and cohort.packed_batches is source
        for bad in ("mom.bam", "mom.npz", "gpubench-reads:aunt", 3):
            with pytest.raises(ValueError, match="no reads"):
                pipeline.packed_batches(bad, cfg)
        with pytest.raises(ValueError, match="another shape"):
            pipeline.packed_batches(source.paths()["mom"], EngineConfig(k=31, batch_reads=32))
        with pytest.raises(ValueError, match="regions"):
            pipeline.packed_batches(source.paths()["mom"], cfg, "chr1")
        for path in source.paths().values():
            assert not path.endswith((".bam", ".npz"))
    assert pipeline.packed_batches is real and cohort.packed_batches is real


def test_seam_check_catches_reads_the_port_did_not_count():
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    samples = _samples()
    cfg = EngineConfig(k=31, batch_reads=64, max_read_len=160)
    source = harness.ReadSource(samples, 64, 10)
    m = source.metrics = Metrics()
    for s in samples:
        list(source(source.paths()[s.name], cfg))
        m.count("reads_ingested", s.n_reads)
    source.check()
    for s in samples:  # the child's reads not counted
        list(source(source.paths()[s.name], cfg))
        m.count("reads_ingested", s.n_reads if s.name != "child" else 0)
    with pytest.raises(RuntimeError, match="reads_ingested"):
        source.check()
    source.calls = []
    list(source(source.paths()["mom"], cfg))  # dad and child never asked for
    m.count("reads_ingested", samples[0].n_reads)
    with pytest.raises(RuntimeError, match="reads_ingested"):
        source.check()


@pytest.mark.parametrize("entry,flags,route", [
    ("pipeline.run_trio", ("-k", "31"), None),
    ("cohort.run_trio_multi_k", ("--ks", "15,21,31,41"), None),
    ("pipeline.run_trio_spill", ("-k", "31"),
     {"table_capacity": 1 << 15, "passes": 2, "spill_slack": 1.1}),
])
@pytest.mark.parametrize("trace", [False, True])
def test_run_cell_on_the_cpu_is_correct(entry, flags, route, trace):
    """A whole run, the chip's look aside: each entry, the spill's route given as data."""
    import json
    import os

    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    cell = tiny_cell(entry, flags, route)
    cell.metrics = bench["per_layer" if trace else "end_to_end"]
    out = harness.run_cell(cell, 2**31 + 77, 0.5, trace, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert all(v == [0, 0] for v in out["check"].values())
    ks = {"pipeline.run_trio": [31], "pipeline.run_trio_spill": [31]}.get(entry, [15, 21, 31, 41])
    assert sorted({int(n.split("_")[0][1:]) for n in out["check"]}) == ks
    if trace:
        assert {"feed_wait_s", "table_device_s", "call_device_s"} <= set(out["metrics"])
        assert "busy_s" in out["device"] and "breakdown" in out
    else:
        assert set(out["metrics"]) == {"trio_reads_per_s", "setup_s"}
