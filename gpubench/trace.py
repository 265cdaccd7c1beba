"""The traced window: a ``torch.profiler`` trace (CPU and CUDA activity) over it, read back
from its Chrome trace into what the device did and what the host did while it idled.

- ``busy_s``: the union of every kernel, copy and memset interval inside the window;
- ``idle_gaps``: the window's idle stretches summed by the innermost harness span
  (``probes``) open at each stretch's middle ("window" outside them), the ten largest;
- ``device_ops``: device seconds by kernel or copy name, the ten largest;
- ``extract_device_s``: the device seconds of the kernels that the spans' thread launched
  inside "extract" spans.

The trace file is written under the run's temporary directory and removed once read.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "window"
SPANS = (WINDOW, "trio", "fold", "extract", "flush", "flush_score", "seed", "call", "report")
TOP = 10


def _name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", s)[:64]


class Recorder:
    """A profiler over the ``with`` body, inside a "window" span (and the trio spans the
    harness opens)."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.span = torch.profiler.record_function(WINDOW)

    def __enter__(self):
        self.prof.__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            t0 = time.perf_counter()
            self.prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        out = summarize(events)
        print(f"gpubench: trace: {size / 1e6:.1f} MB, {len(events)} events, read in "
              f"{time.perf_counter() - t0:.2f} s; {out and out['device_events']} device "
              f"events, {out and out['extract_kernels']} launched in extract spans",
              file=sys.stderr, flush=True)
        return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end) rows of an (n, 2) array."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], 1)


def _innermost(spans: List[tuple], points: np.ndarray) -> List[str]:
    """The name of the innermost span holding each of the sorted ``points`` (nested
    spans of one thread), or WINDOW."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else WINDOW)
    return out


def summarize(events: List[dict]) -> Optional[dict]:
    """The window's device and host readings of a Chrome trace's events; None without a
    window span."""
    window, spans, extract, dev = None, [], [], []
    launch: Dict[int, tuple] = {}  # correlation id → (launch time, thread)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name, (e.get("args") or {}).get("correlation")))
        elif cat == "user_annotation" and name in SPANS:
            if name == WINDOW:
                window, thread = (ts, ts + dur), e.get("tid")
            else:
                spans.append((ts, ts + dur, name))
                if name == "extract":
                    extract.append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (ts, e.get("tid"))
    if window is None:
        return None
    w0, w1 = window
    inside = [d for d in dev if d[1] > w0 and d[0] < w1]
    iv = np.array([(max(a, w0), min(b, w1)) for a, b, _n, _c in inside]).reshape(-1, 2)
    busy = _union(iv)
    edges = np.r_[w0, busy.ravel(), w1].reshape(-1, 2)  # [idle start, idle end] rows
    gaps = edges[edges[:, 1] > edges[:, 0]]
    by_span: Dict[str, float] = {}
    for (a, b), name in zip(gaps, _innermost(spans, (gaps[:, 0] + gaps[:, 1]) / 2)):
        by_span[name] = by_span.get(name, 0.0) + float(b - a) * 1e-6
    ops: Dict[str, float] = {}
    for a, b, name, _c in inside:
        ops[_name(name)] = ops.get(_name(name), 0.0) + (min(b, w1) - max(a, w0)) * 1e-6
    ex = np.array(sorted(extract)).reshape(-1, 2)
    extract_s, matched = 0.0, 0
    for a, b, _n, corr in inside:
        t, tid = launch.get(corr, (None, None))
        if t is None or tid != thread or not len(ex):  # the spans' thread launched it
            continue
        j = np.searchsorted(ex[:, 0], t, side="right") - 1
        if j >= 0 and t <= ex[j, 1]:
            extract_s += (b - a) * 1e-6
            matched += 1
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0,
            "window_s": (w1 - w0) * 1e-6, "device_ops": top(ops), "idle_gaps": top(by_span),
            "extract_device_s": extract_s if matched else None,
            "extract_kernels": matched, "device_events": len(inside)}
