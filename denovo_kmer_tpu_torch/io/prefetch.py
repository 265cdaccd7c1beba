"""Double-buffered host→device feeding.

The host decode/pack path and the device pipeline (extract → append → flush) run on different
resources; without overlap the card idles during host work and vice versa.
``prefetch_batches`` (a copy of ``denovo_kmer_tpu/io/prefetch.py``'s) wraps any packed-batch
iterator with a daemon thread and a bounded queue so batch N+1 is decoded while batch N
computes. ``prefetch_placed`` adds a second thread that places each batch on the device.

Placement on CUDA: each array is copied into pinned host memory and sent with
``.to(device, non_blocking=True)`` on a side CUDA stream, and an event is recorded after the
batch. The consumer's stream waits on that event before it uses the batch, and each tensor
is marked with ``record_stream`` so the caching allocator does not hand its memory to the
side stream while the consumer's kernels may still read it. On the CPU the arrays pass
through as tensors that share their memory.

Exceptions raised by the producer are re-raised in the consumer at the point of ``next()``.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.pack import PackedReads

T = TypeVar("T")

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_batches(batches: Iterable[T], depth: int = 2,
                     stats: dict = None) -> Iterator[T]:
    """Iterate ``batches`` with a background producer thread and a bounded queue.

    ``depth`` bounds host memory: at most ``depth`` packed batches are in flight beyond the
    one being consumed. Order is preserved. If the consumer exits early (exception in the
    processing loop, ``break``, generator close), the producer is signalled to stop — it
    never stays blocked on a full queue holding the input stream open.

    ``stats``: optional dict accumulating ``consumer_wait_s`` (time the consumer sat starved
    on an empty queue — high means the FEEDER is the bottleneck) and ``producer_wait_s``
    (producer blocked on a full queue — the device is) plus ``items``. Each key is written
    by exactly one thread."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    if stats is not None:
        stats.setdefault("consumer_wait_s", 0.0)
        stats.setdefault("producer_wait_s", 0.0)
        stats.setdefault("items", 0)

    def produce():
        try:
            for b in batches:
                t_put0 = time.perf_counter()
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stats is not None:
                    stats["producer_wait_s"] += time.perf_counter() - t_put0
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised consumer-side
            while not stop.is_set():  # never block forever on a gone consumer
                try:
                    q.put(_Failure(e), timeout=0.1)
                    break
                except queue.Full:
                    continue
            return
        while not stop.is_set():
            try:
                q.put(_DONE, timeout=0.1)
                break
            except queue.Full:
                continue

    t = threading.Thread(target=produce, daemon=True, name="denovo-kmer-prefetch")
    t.start()
    try:
        t_start = time.perf_counter()
        while True:
            t_get0 = time.perf_counter()
            item = q.get()
            if stats is not None:
                stats["consumer_wait_s"] += time.perf_counter() - t_get0
                stats["wall_s"] = time.perf_counter() - t_start
            if item is _DONE:
                return
            if isinstance(item, _Failure):
                raise item.exc
            if stats is not None:
                stats["items"] += 1
            yield item
    finally:
        stop.set()
        try:  # unblock a producer waiting on a full queue
            q.get_nowait()
        except queue.Empty:
            pass
        # join before returning: callers close their input stream right after closing
        # this generator, and the producer thread must not still be inside that stream
        t.join(timeout=10.0)
        if t.is_alive():  # pragma: no cover - pathological stall
            if stats is not None:
                stats["producer_leaked"] = True
            # keep the input iterable reachable for the leaked thread's lifetime
            _LEAKED_PRODUCERS.append((t, batches))
            print("denovo-kmer-prefetch: producer thread did not stop within 10 s; "
                  "leaking the thread instead of racing it", file=sys.stderr)


#: (thread, input-iterable) pairs whose producer outlived the join timeout
_LEAKED_PRODUCERS: list = []


def close_unless_leaked(stream, stats: dict) -> None:
    """Close ``stream`` unless ``stats`` (the dict passed to the prefetch over it) recorded a
    leaked producer thread: that thread may still be inside the stream's decode, and closing
    it underneath would be a use-after-free; the handle is leaked with the thread."""
    if stats and stats.get("producer_leaked"):
        print("denovo-kmer-prefetch: leaving stream open (leaked producer thread may still "
              "hold it)", file=sys.stderr)
        return
    stream.close()


def _place_item(item, put: Callable, ship_lengths: bool = False):
    """Replace every PackedReads in ``item`` (bare, or inside a tuple such as
    ``(bucket_width, packed)`` or ``(packed, cursor)``) with a copy whose ``words`` and
    ``vwords`` are tensors on the device; anything else passes through.

    ``ship_lengths``: prefix-valid batches (no Ns, no quality masking — the common case)
    transfer (B,) lengths instead of (B, Lp/32) vwords and arrive with ``vwords=None``."""
    if isinstance(item, PackedReads):
        if ship_lengths and item.prefix_valid:
            return dataclasses.replace(
                item, words=put(item.words), vwords=None, length=put(item.length)
            )
        return dataclasses.replace(item, words=put(item.words), vwords=put(item.vwords))
    if isinstance(item, tuple):
        return tuple(_place_item(x, put, ship_lengths) for x in item)
    return item


def _placed_tensors(item) -> Iterator[torch.Tensor]:
    if isinstance(item, PackedReads):
        for t in (item.words, item.vwords, item.length):
            if isinstance(t, torch.Tensor):
                yield t
    elif isinstance(item, tuple):
        for x in item:
            yield from _placed_tensors(x)


def as_int32_tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor sharing ``a``'s memory, with uint32 words seen as int32 (same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype != np.int32:
        raise TypeError(f"expected uint32 or int32 batch arrays, got {a.dtype}")
    return torch.from_numpy(a)


def prefetch_placed(batches: Iterable[T], device, depth: int = 2,
                    decode_depth: int = 2, ship_lengths: bool = False,
                    stats: dict = None) -> Iterator[T]:
    """Three-thread host→device pipeline: decode/pack on one daemon thread, host→device
    transfer on a second (a side CUDA stream), compute dispatch on the caller's thread.
    Items are PackedReads, bare or inside tuples (``_place_item``).

    ``stats`` track the consumer-facing stage; a leaked decode thread (the one inside the
    caller's stream) is reported there too, for ``close_unless_leaked``."""
    device = torch.device(device)
    inner_stats: dict = {}
    inner = prefetch_batches(batches, depth=decode_depth, stats=inner_stats)
    if device.type == "cuda":
        side = torch.cuda.Stream(device=device)

        def put(a):
            host = as_int32_tensor(a).pin_memory()
            with torch.cuda.stream(side):
                return host.to(device, non_blocking=True)

        def place(b):
            placed = _place_item(b, put, ship_lengths)
            ready = torch.cuda.Event()
            ready.record(side)
            return placed, ready
    else:
        def place(b):
            return _place_item(b, as_int32_tensor, ship_lengths), None

    outer = prefetch_batches((place(b) for b in inner), depth=depth, stats=stats)
    try:
        for item, ready in outer:
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in _placed_tensors(item):
                    t.record_stream(consumer)
            yield item
    finally:
        # close the transfer stage first (its finally joins the transfer thread), then
        # the decode stage — only then may the caller close the input stream underneath
        outer.close()
        try:
            inner.close()
        except ValueError:  # transfer-thread join timed out mid-iteration
            pass
        if stats is not None and inner_stats.get("producer_leaked"):
            stats["producer_leaked"] = True
