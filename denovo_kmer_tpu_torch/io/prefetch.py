"""Double-buffered host→device feeding.

The host decode/pack path and the device pipeline (extract → append → flush) run on different
resources; without overlap the card idles during host work and vice versa.
``prefetch_batches`` (a copy of ``denovo_kmer_tpu/io/prefetch.py``'s) wraps any packed-batch
iterator with a daemon thread and a bounded queue so batch N+1 is decoded while batch N
computes. ``prefetch_placed`` places each decoded batch on the device.

Every feed is one loop: a daemon thread decodes, and the caller's (the dispatch) thread places
each batch when it asks for the next one. A transfer thread of its own would hand each batch
across once more and contend with the dispatch loop for the GIL; on the card that cost the
feed more than the copy it overlapped. Only the placement differs: ``put`` when the caller
gives one; on the CPU the arrays pass through as tensors that share their memory; on CUDA a
ring of reused pinned staging slots (``StagingRing``), which the feed allocates once and
frees when it closes, however it closes. Each batch takes the ring's next slot: every array
it ships (``words``, then ``vwords`` or ``length``) is copied into its own 256-B aligned
segment of the slot, and the slot's used prefix goes to the device in one ``non_blocking``
copy, on the caller's current stream, into one fresh device buffer from the caching
allocator; the batch's tensors are contiguous views of that buffer, ordered after the copy by
the stream itself (a caller that uses a batch on another stream waits for and
``record_stream``s it there). An event recorded after the copy marks the slot: the ring
refills a slot only after its event has completed. Device buffers are not ringed: a caller
may hold a placed batch past its next ``next()`` (the ``(packed, cursor)`` feed of a
resumable count, the spill's staging window), so their lifetimes stay with the caching
allocator. A slot is sized to the first batch it holds and re-allocated only when a larger
one arrives (a bucketed stream).

Exceptions raised by the producer are re-raised in the consumer at the point of ``next()``.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.pack import PackedReads
from denovo_kmer_tpu_torch.utils.device import resolve_device
from denovo_kmer_tpu_torch.utils.metrics import span

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


def _as_int32(a: np.ndarray) -> np.ndarray:
    """``a`` contiguous, with uint32 words seen as int32 (same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype != np.int32:
        raise TypeError(f"expected uint32 or int32 batch arrays, got {a.dtype}")
    return a


def as_int32_tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor sharing ``a``'s memory, with uint32 words seen as int32 (same bits)."""
    return torch.from_numpy(_as_int32(a))


#: int32 elements between segment starts in a staging slot and its device buffer (256 B)
_ALIGN = 64


class StagingRing:
    """``n_slots`` reused host staging slots: one host copy an array and one transfer a batch.

    ``alloc(n)`` makes a slot of ``n`` int32 elements (pinned memory on CUDA);
    ``transfer(host)`` starts the copy of a slot's used prefix to the device and returns
    ``(buffer, event)``, the event completing when the slot may be refilled. Slots are used in
    turn; a slot is refilled only after its last event has completed (``query()``, then
    ``synchronize()`` if it has not). ``stats`` gets ``feed_staged`` (batches placed),
    ``feed_ring_waits`` (refills that found their slot's transfer in flight),
    ``feed_ring_wait`` (the seconds those refills waited), ``feed_ring_grows`` (slot
    re-allocations) and ``feed_place_cpu`` (the placing thread's CPU seconds), all written
    by the one thread that places."""

    def __init__(self, n_slots: int, alloc: Callable, transfer: Callable,
                 stats: dict = None):
        self.alloc, self.transfer = alloc, transfer
        self.slots: list = [None] * n_slots
        self.hosts: list = [None] * n_slots  # each slot's memory as a numpy array
        self.events: list = [None] * n_slots
        self.turn = 0
        self.stats = stats if stats is not None else {}
        for key in ("feed_staged", "feed_ring_waits", "feed_ring_grows"):
            self.stats.setdefault(key, 0)
        for key in ("feed_ring_wait", "feed_place_cpu"):
            self.stats.setdefault(key, 0.0)

    def place(self, item, ship_lengths: bool = False):
        """``item`` with the arrays it ships (``_place_item``) as views of one device buffer;
        an item with no PackedReads passes through."""
        t0 = time.thread_time()
        arrays: list = []
        _place_item(item, lambda a: arrays.append(_as_int32(a)), ship_lengths)
        if not arrays:
            return item
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.size // _ALIGN) * _ALIGN
        i = self.turn
        self.turn = (i + 1) % len(self.slots)
        event = self.events[i]
        if event is not None and not event.query():
            self.stats["feed_ring_waits"] += 1
            t_wait = time.perf_counter()
            event.synchronize()
            self.stats["feed_ring_wait"] += time.perf_counter() - t_wait
        slot = self.slots[i]
        if slot is None or slot.numel() < total:
            if slot is not None:
                self.stats["feed_ring_grows"] += 1
            self.slots[i] = self.hosts[i] = None  # free the smaller slot first
            slot = self.slots[i] = self.alloc(total)
            self.hosts[i] = slot.numpy()
        host = self.hosts[i]
        for a, o in zip(arrays, offsets):
            # numpy's copy: one memcpy without the GIL and without torch's intra-op threads,
            # whose team spins on the host's cores after each parallel copy
            np.copyto(host[o:o + a.size].reshape(a.shape), a)
        buffer, self.events[i] = self.transfer(slot.narrow(0, 0, total))
        # the same walk as the one that listed the arrays, so each gets its own view
        views = iter([buffer.narrow(0, o, a.size).view(a.shape)
                      for a, o in zip(arrays, offsets)])
        placed = _place_item(item, lambda _a: next(views), ship_lengths)
        self.stats["feed_staged"] += 1
        self.stats["feed_place_cpu"] += time.thread_time() - t0
        return placed

    def close(self) -> None:
        """Free the slots (a transfer still in flight keeps its pinned block in the caching
        host allocator until it completes)."""
        n = len(self.slots)
        self.slots, self.hosts, self.events = [None] * n, [None] * n, [None] * n


def _cuda_ring_parts(device: torch.device) -> tuple:
    """(alloc, transfer) of a ring on ``device``: pinned slots, and the copy of a slot into a
    fresh device buffer on the device's current stream, with an event after it."""
    def alloc(n):
        return torch.empty(n, dtype=torch.int32, pin_memory=True)

    def transfer(host):
        buffer = torch.empty(host.shape, dtype=torch.int32, device=device)
        buffer.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return buffer, event

    return alloc, transfer


def prefetch_placed(batches: Iterable[T], device=None, depth: int = 2,
                    decode_depth: int = 2, put: Callable = None,
                    ship_lengths: bool = False, stats: dict = None) -> Iterator[T]:
    """Host→device pipeline: decode/pack on a daemon thread behind a queue of
    ``decode_depth + depth`` batches, then placement and compute dispatch on the caller's
    thread (``_feed``). Items are PackedReads, bare or inside tuples (``_place_item``),
    placed on ``device`` (``None``: the card).

    On CUDA each batch goes through a ring of ``depth + 1`` reused pinned staging slots
    (``StagingRing``, the module's docstring): one host copy an array and one transfer a
    batch on the caller's current stream, a slot refilled only once its last transfer has
    completed. The device buffers stay with the caching allocator, since a caller may hold a
    placed batch past its next ``next()``. The ring's tallies go into ``stats``.

    ``put`` overrides the placement: each host array of a batch becomes ``put(array)``
    (``device`` is then unused), and the caller orders the copies it makes. ``stats`` track
    the consumer-facing stage (``_feed``); a leaked decode thread (the one inside the
    caller's stream) is reported there too, for ``close_unless_leaked``."""
    device = None if put is not None else resolve_device(device)
    ring = None
    if put is not None:
        place = functools.partial(_place_item, put=put, ship_lengths=ship_lengths)
    elif device.type == "cuda":
        ring = StagingRing(depth + 1, *_cuda_ring_parts(device), stats)
        place = functools.partial(ring.place, ship_lengths=ship_lengths)
    else:
        place = functools.partial(_place_item, put=as_int32_tensor, ship_lengths=ship_lengths)
    yield from _feed(batches, place, decode_depth + depth, stats, ring)


def _feed(batches: Iterable, place: Callable, depth: int, stats: dict = None,
          ring: StagingRing = None) -> Iterator:
    """``place(batch)`` for each of ``batches``, decoded on a daemon thread behind a queue of
    ``depth`` (``prefetch_batches``, which keeps ``stats``), placed on the caller's thread
    when it is asked for. ``consumer_wait_s`` and each ``feed_wait`` span of the running call
    (``utils/metrics.py``) are the caller's time to get its next placed batch: its wait on
    the decode thread and the placement. Closing the feed, early or on an error, joins the
    decode thread and frees ``ring``."""
    inner = prefetch_batches(batches, depth=depth, stats=stats)
    try:
        while True:
            with span("feed_wait"):
                batch = next(inner, _DONE)
                if batch is _DONE:
                    return
                t0 = time.perf_counter()
                item = place(batch)
            if stats is not None:
                stats["consumer_wait_s"] += time.perf_counter() - t0
            yield item
    finally:
        inner.close()  # joins the decode thread before the caller closes its stream
        if ring is not None:
            ring.close()
