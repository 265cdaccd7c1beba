"""Structured metrics: counters, per-stage seconds and k-mers/s, emitted as JSON lines and
a human summary (a copy of ``denovo_kmer_tpu/utils/metrics.py``), and the port's spans.

Spans. ``Metrics.span(name, device)`` and ``Metrics.timer(name)`` (a span that also adds its
seconds to ``seconds[name]``) bind their Metrics for their body, so the ops reach the running
call's Metrics through the module-level ``span`` and ``tally`` without a parameter; work
outside every span and timer of a Metrics records nowhere. A span records only while a
``torch.profiler`` is enabled; otherwise it costs that one check (``tracing``). When it
records, it:

- opens ``torch.profiler.record_function(name)``, so it sits in the profiler's trace on the
  clock of the device's activity;
- appends a ``SpanRecord`` (name, host start and end, parent span, thread) to
  ``Metrics.spans``, kept in memory and read after the run (``span_seconds``);
- with a CUDA ``device``, records a CUDA event pair on the device's current stream, read with
  one synchronize when first asked for; on the CPU the device seconds are the host's.

Tallies (``Metrics.tallies``, e.g. ``rows_sorted``) count whether or not a profiler runs. A
count known only on the device (``rows_merged``) is tallied as a 0-dim tensor and summed
there, with no host sync; ``int()`` reads it.
Neither spans nor tallies enter ``summary()`` or ``to_dict()``, which stay the JAX
package's.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, TextIO

import torch

#: True while a torch profiler records: the one check a span makes when none does
tracing = torch._C._autograd._profiler_enabled

#: (the Metrics a span or timer bound, the index of its innermost open span or None)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("denovo_kmer_metrics",
                                                          default=(None, None))
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class SpanRecord:
    name: str
    start: float  # host perf_counter seconds
    end: float
    parent: Optional[int]  # index in the same Metrics' spans, None at the top
    thread: int  # native thread id, as the profiler's trace names threads
    device_s: Optional[float] = None  # a device span's seconds, once read
    events: Optional[tuple] = None  # a CUDA span's (start, end) events until read


class _Span:
    """A span of ``metrics`` (None: record_function only), optionally a timer too."""

    __slots__ = ("m", "name", "device", "timer", "t0", "token", "rf", "rec", "ev")

    def __init__(self, metrics, name: str, device=None, timer: bool = False):
        self.m, self.name, self.device, self.timer = metrics, name, device, timer

    def __enter__(self):
        self.t0 = time.perf_counter()
        m = self.m
        self.rf = self.rec = self.ev = None
        index = None
        if tracing():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            if m is not None:
                owner, parent = _ACTIVE.get()
                # the thread's id as the profiler names it, kept by its Thread object (no
                # system call)
                self.rec = SpanRecord(self.name, 0.0, 0.0, parent if owner is m else None,
                                      threading.current_thread().native_id)
                index = len(m.spans)
                m.spans.append(self.rec)
                if self.device is not None and self.device.type == "cuda":
                    self.ev = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                    self.ev[0].record(torch.cuda.current_stream(self.device))
        self.token = _ACTIVE.set((m, index)) if m is not None else None
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.token is not None:
            _ACTIVE.reset(self.token)
        if self.timer:
            self.m.add_seconds(self.name, t1 - self.t0)
        rec = self.rec
        if rec is not None and self.ev is not None:
            self.ev[1].record(torch.cuda.current_stream(self.device))
            rec.events = self.ev
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if rec is not None:  # the record's own cost stays inside it, out of its parent's
            rec.start, rec.end = self.t0, time.perf_counter()
            if self.device is not None and self.ev is None:
                rec.device_s = rec.end - rec.start
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A span of the running call's Metrics (see the module's docstring); ``device`` is
    where the span's work runs, None for host work."""
    if not tracing():
        return _OFF
    return _Span(_ACTIVE.get()[0], name, device)


def tally(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-dim tensor summed on its device) to the running call's
    tally ``name`` (nothing outside a call)."""
    m = _ACTIVE.get()[0]
    if m is not None:
        m.tallies[name] += n


class Metrics:
    def __init__(self, json_stream: Optional[TextIO] = None):
        self.counters: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.tallies: Dict[str, int] = defaultdict(int)
        self.spans: List[SpanRecord] = []
        self._json = json_stream

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += int(n)

    def add_seconds(self, name: str, s: float) -> None:
        self.seconds[name] += s

    def timer(self, name: str) -> _Span:
        """Add the body's host seconds to ``seconds[name]``; a span of that name too."""
        return _Span(self, name, timer=True)

    def span(self, name: str, device: Optional[torch.device] = None) -> _Span:
        return _Span(self, name, device)

    def span_seconds(self, name: str, device: bool = False, own: bool = False) -> float:
        """Seconds in the recorded spans called ``name``: host seconds; with ``own``, host
        seconds outside their child spans; with ``device``, the device seconds of device
        spans (their CUDA events, one synchronize the first time they are read)."""
        spans = self.spans
        if device:
            pending = [r for r in spans if r.events is not None]
            if pending:
                torch.cuda.synchronize()
                for r in pending:
                    r.device_s = r.events[0].elapsed_time(r.events[1]) / 1e3
                    r.events = None
            return sum(r.device_s for r in spans if r.name == name and r.device_s is not None)
        total = sum(r.end - r.start for r in spans if r.name == name)
        if own:
            total -= sum(r.end - r.start for r in spans
                         if r.parent is not None and spans[r.parent].name == name)
        return total

    def merge_from(self, other: "Metrics") -> None:
        """Fold another Metrics' counters/timers (and tallies and spans) into this one."""
        for k, v in other.counters.items():
            self.counters[k] += v
        for k, v in other.seconds.items():
            self.seconds[k] += v
        for k, v in other.tallies.items():
            self.tallies[k] += v
        at = len(self.spans)
        self.spans += [dataclasses.replace(
            r, parent=None if r.parent is None else r.parent + at) for r in other.spans]

    def event(self, name: str, **fields) -> None:
        if self._json is not None:
            rec = {"event": name, "t": time.time(), **fields}
            self._json.write(json.dumps(rec) + "\n")
            self._json.flush()

    def rate(self, counter: str, timer: str) -> float:
        s = self.seconds.get(timer, 0.0)
        return self.counters.get(counter, 0) / s if s > 0 else 0.0

    def summary(self) -> str:
        lines = ["== metrics =="]
        for k in sorted(self.counters):
            lines.append(f"  {k}: {self.counters[k]}")
        for k in sorted(self.seconds):
            lines.append(f"  {k}: {self.seconds[k]:.3f}s")
        if "kmers_extracted" in self.counters and "extract_probe" in self.seconds:
            lines.append(
                f"  kmers/s (extract+probe): {self.rate('kmers_extracted', 'extract_probe'):.3e}"
            )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"counters": dict(self.counters), "seconds": dict(self.seconds)}


class StageTimer:
    """Tiny helper for one-off stage timing."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
