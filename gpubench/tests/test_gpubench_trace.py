"""The traced window's reading of a Chrome trace."""

from gpubench import trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_busy_idle_spans_and_extract_kernels():
    events = [
        _x("user_annotation", "window", 0, 100),
        _x("user_annotation", "trio", 0, 100),
        _x("user_annotation", "fold", 5, 60),
        _x("user_annotation", "extract", 12, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
        _x("cuda_runtime", "cudaMemcpyAsync", 14, 1, tid=2, corr=2),  # another thread
        _x("kernel", "extract_kmers_kernel", 20, 4, corr=1),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 22, 6, corr=2),
        _x("user_annotation", "report", 70, 20),
        _x("kernel", "sort", 40, 10, corr=3),
        _x("kernel", "outside", 120, 10, corr=4),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50},
    ]
    out = trace.summarize(events)
    assert abs(out["window_s"] - 100e-6) < 1e-12
    assert abs(out["busy_s"] - 18e-6) < 1e-12  # [20, 28) and [40, 50)
    gaps = dict(out["idle_gaps"])
    assert abs(gaps["fold"] - 32e-6) < 1e-12  # [0, 20) has its middle in fold, [28, 40)
    assert abs(gaps["report"] - 50e-6) < 1e-12  # [50, 100): middle 75 in report
    assert out["extract_kernels"] == 1 and abs(out["extract_device_s"] - 4e-6) < 1e-12
    assert dict(out["device_ops"])["extract_kmers_kernel"] == 4e-6
    assert "outside" not in dict(out["device_ops"])
    assert len(out["device_ops"]) <= trace.TOP and len(out["idle_gaps"]) <= trace.TOP


def test_summarize_without_a_window_or_device_events():
    assert trace.summarize([_x("kernel", "k", 0, 1)]) is None
    out = trace.summarize([_x("user_annotation", "window", 0, 10)])
    assert out["busy_s"] == 0.0 and out["extract_device_s"] is None
    assert [n for n, _s in out["idle_gaps"]] == ["window"]
    assert abs(out["idle_gaps"][0][1] - 10e-6) < 1e-12


def test_innermost_span_of_nested_spans():
    spans = [(0, 100, "trio"), (10, 50, "fold"), (20, 30, "extract"), (60, 90, "report")]
    assert trace._innermost(spans, [5, 25, 40, 55, 70, 95, 120]) == [
        "trio", "extract", "fold", "trio", "report", "trio", "window"]
