"""The traced run's instruments around the port's steps, bound only while the window runs.

Each wrapper opens a ``torch.profiler.record_function`` span named for what it wraps, so
the trace can tell what the host was doing through each idle gap and which kernels the
ingest step launched. The table steps (``flush``, ``flush_score``, ``seed_score_table``)
and the call (``fused_call_full``, ``call_from_score``) are timed by CUDA events around
each call, as ``chip_smoke.py``'s table-step timer does; for each table step the rows it
needs are kept: its input tables' filled rows, its staged rows and its output's filled rows.

| span | wraps (name in ``pipeline``, and ``cohort`` where it imports it) |
| --- | --- |
| fold | ``_fold_stream``: a sample's stream through its lanes |
| extract | ``_extract_append``: the ingest step of one batch into one lane |
| flush, flush_score, seed | the table steps |
| call | ``fused_call_full``, ``call_from_score`` |
| report | ``_trio_result``: the host's candidate rows and TSV |
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import List

import torch

from gpubench import roofline

PORT = "denovo_kmer_tpu_torch"


class _Clock:
    """A pair of marks around a step: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        if on_card:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def begin(self):
        if self.on_card:
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.on_card:
            self.end.record()
        else:
            self.s = time.perf_counter() - self.t0

    def seconds(self) -> float:
        return self.start.elapsed_time(self.end) / 1e3 if self.on_card else self.s


class Probe:
    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.table: List[tuple] = []  # (clock, [(n tensor, row bytes)], staged bytes)
        self.calls: List[_Clock] = []
        self.extract: List[tuple] = []  # (bytes, operations) a launch
        self.table_s = self.table_bytes = self.call_s = None
        self.extract_bound_s = None

    def _span(self, name, real):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return real(*a, **kw)
        return wrapped

    def _timed(self, name, real, rows, into):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                clock = _Clock(self.on_card)
                clock.begin()
                out = real(*a, **kw)
                clock.stop()
            if rows is None:
                into.append(clock)
            else:
                into.append((clock, *rows(out, *a, **kw)))
            return out
        return wrapped

    def _extract(self, real):
        def wrapped(acc, words, vwords, lengths, k, max_read_len, canonical=True,
                    *a, **kw):
            B, Lw = words.shape
            self.extract.append(roofline.extraction_bytes_ops(
                B, Lw, k, max_read_len, canonical, vwords is not None))
            with torch.profiler.record_function("extract"):
                return real(acc, words, vwords, lengths, k, max_read_len, canonical,
                            *a, **kw)
        return wrapped

    @staticmethod
    def _flush_rows(out, acc, table, *_a, **_k):
        """A flush: its table's and its output's filled rows, its staged rows."""
        W = table.keys.shape[1]
        row = (roofline.score_table_row(W) if hasattr(table, "pcounts")
               else roofline.kmer_table_row(W))
        return [(table.n, row), (out[1].n, row)], acc.fill * roofline.staged_row(W)

    @staticmethod
    def _seed_rows(out, mom, dad, *_a, **_k):
        W = mom.keys.shape[1]
        row = roofline.kmer_table_row(W)
        return [(mom.n, row), (dad.n, row), (out.n, roofline.score_table_row(W))], 0

    @contextlib.contextmanager
    def installed(self):
        pipeline = importlib.import_module(f"{PORT}.pipeline")
        cohort = importlib.import_module(f"{PORT}.cohort")
        wraps = {
            "_fold_stream": lambda real: self._span("fold", real),
            "_extract_append": self._extract,
            "flush": lambda real: self._timed("flush", real, self._flush_rows, self.table),
            "flush_score": lambda real: self._timed("flush_score", real, self._flush_rows,
                                                    self.table),
            "seed_score_table": lambda real: self._timed("seed", real, self._seed_rows,
                                                         self.table),
            "fused_call_full": lambda real: self._timed("call", real, None, self.calls),
            "call_from_score": lambda real: self._timed("call", real, None, self.calls),
            "_trio_result": lambda real: self._span("report", real),
        }
        saved = []
        for mod in (pipeline, cohort):
            for name, wrap in wraps.items():
                if name in vars(mod):
                    real = getattr(mod, name)
                    saved.append((mod, name, real))
                    setattr(mod, name, wrap(real))
        try:
            yield self
        finally:
            for mod, name, real in saved:
                setattr(mod, name, real)

    def finish(self) -> None:
        """Read the clocks and the rows (synchronizes)."""
        if self.on_card:
            torch.cuda.synchronize()
        ns = [n for _c, rows, _s in self.table for n, _r in rows]
        counts = torch.stack([n.reshape(()).long() for n in ns]).tolist() if ns else []
        i = 0
        total = 0
        for _clock, rows, staged in self.table:
            total += staged
            for _n, row in rows:
                total += counts[i] * row
                i += 1
        self.table_bytes = total
        self.table_s = sum(c.seconds() for c, _r, _s in self.table)
        self.call_s = sum(c.seconds() for c in self.calls)
        if self.on_card and self.extract:
            rate = roofline.int_ops_per_s(
                torch.cuda.get_device_properties(0).multi_processor_count)
            if rate is not None:
                self.extract_bound_s = sum(
                    max(b / roofline.HBM_BYTES_PER_S, ops / rate) for b, ops in self.extract)
