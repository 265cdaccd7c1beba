"""Structured metrics: counters, per-stage seconds and k-mers/s, emitted as JSON lines and
a human summary. A copy of ``denovo_kmer_tpu/utils/metrics.py``."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional, TextIO


class Metrics:
    def __init__(self, json_stream: Optional[TextIO] = None):
        self.counters: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)
        self._json = json_stream

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += int(n)

    def add_seconds(self, name: str, s: float) -> None:
        self.seconds[name] += s

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_seconds(name, time.perf_counter() - t0)

    def merge_from(self, other: "Metrics") -> None:
        """Fold another Metrics' counters/timers into this one."""
        for k, v in other.counters.items():
            self.counters[k] += v
        for k, v in other.seconds.items():
            self.seconds[k] += v

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
