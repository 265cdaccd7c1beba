"""The feed's staging ring (``io/prefetch.StagingRing``): on the CPU through its seam, with
unpinned slots and a transfer whose copy lands when its event completes; on the card as
``prefetch_placed`` builds it (``_cuda_ring_parts``)."""

import functools
import random
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from denovo_kmer_tpu_torch import pipeline
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.prefetch import (
    StagingRing,
    _cuda_ring_parts,
    _feed,
    _place_item,
    as_int32_tensor,
    prefetch_placed,
)
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops.pack import PackedReads
from denovo_kmer_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)


class FakeEvent:
    """A transfer's event on the CPU: its copy lands when the event completes, at once or,
    ``lazy``, only when it is waited on (or the card is synchronized); a wait on it takes
    ``sync_s`` seconds."""

    def __init__(self, land, lazy: bool, sync_s: float = 0.0):
        self.land, self.done, self.synced, self.sync_s = land, False, False, sync_s
        if not lazy:
            self.complete()

    def complete(self):
        if not self.done:
            self.land()
            self.land, self.done = None, True

    def query(self):
        return self.done

    def synchronize(self):
        self.synced = True
        time.sleep(self.sync_s)
        self.complete()


class FakeCard:
    """(alloc, transfer) of a ring on the CPU, a transfer taking ``transfer_s`` seconds; the
    slots it made (weakly), its events and the threads that started its transfers."""

    def __init__(self, lazy: bool = False, sync_s: float = 0.0, transfer_s: float = 0.0):
        self.lazy, self.sync_s, self.transfer_s = lazy, sync_s, transfer_s
        self.slots, self.events, self.threads = [], [], set()

    def alloc(self, n):
        slot = torch.full((n,), -7, dtype=torch.int32)
        self.slots.append(weakref.ref(slot))
        return slot

    def transfer(self, host):
        self.threads.add(threading.current_thread())
        time.sleep(self.transfer_s)
        buffer = torch.full_like(host, -1)
        self.events.append(FakeEvent(lambda: buffer.copy_(host), self.lazy, self.sync_s))
        return buffer, self.events[-1]

    def synchronize(self):
        """Land every transfer, as a read after the copy on its stream would see it."""
        for event in self.events:
            event.complete()

    def feed(self, batches, depth=2, ship_lengths=True, stats=None):
        """``prefetch_placed``'s CUDA feed with this card's parts: ``depth + 1`` slots."""
        ring = StagingRing(depth + 1, self.alloc, self.transfer, stats)
        place = functools.partial(ring.place, ship_lengths=ship_lengths)
        return _feed(batches, place, 2 + depth, stats, ring)


def _batch(rng, B=8, Lw=5, prefix_valid=False):
    """Random bits in every array (the high bit too), as a packed batch's shapes."""
    bits = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return PackedReads(words=bits(B, Lw), vwords=bits(B, -(-Lw // 2)),
                       length=rng.integers(0, 16 * Lw, B).astype(np.int32), n_reads=B,
                       prefix_valid=prefix_valid)


def _want(b, ship_lengths=True):
    return _place_item(b, as_int32_tensor, ship_lengths)


def _same(got, want):
    """Placed batches equal bit for bit, tensor for tensor and host array for host array."""
    for name in ("words", "vwords", "length"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None or isinstance(w, np.ndarray):
            assert g is w, name
        else:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.int32, name
            assert g.shape == w.shape and torch.equal(g.cpu(), w), name
    assert got.n_reads == want.n_reads and got.prefix_valid == want.prefix_valid


@pytest.mark.parametrize("feed", ["vwords", "lengths"])
@pytest.mark.parametrize("lazy", [False, True])
def test_ring_round_trip_is_bitwise(feed, lazy):
    """words + vwords (a batch with an N) or words + length (prefix-valid, ``ship_lengths``),
    each batch as the unstaged placement has it, with transfers that land at once or only
    when waited on."""
    rng = np.random.default_rng(1)
    batches = [_batch(rng, B=8 + i % 3, prefix_valid=feed == "lengths") for i in range(40)]
    stats, card = {}, FakeCard(lazy)
    got = list(card.feed(iter(batches), stats=stats))
    card.synchronize()
    assert len(got) == len(batches) == stats["feed_staged"]
    for g, b in zip(got, batches):
        _same(g, _want(b))
    assert (got[0].vwords is None) == (feed == "lengths")


@pytest.mark.parametrize("shape", ["width", "cursor"])
def test_ring_keeps_tuple_items_in_order(shape):
    """``(width, packed)`` of a bucketed stream and ``(packed, cursor)`` of a resumable
    count come out in order, the packed batch placed and the rest as it was."""
    rng = np.random.default_rng(2)
    batches = [_batch(rng, prefix_valid=i % 2 == 0) for i in range(12)]
    items = [((32 * (1 + i % 3), b) if shape == "width" else (b, 100 + i))
             for i, b in enumerate(batches)]
    card = FakeCard(lazy=True)
    got = list(card.feed(iter(items)))
    card.synchronize()
    assert len(got) == len(items)
    for g, item in zip(got, items):
        pos = 1 if shape == "width" else 0
        assert g[1 - pos] == item[1 - pos]
        _same(g[pos], _want(item[pos]))


def test_a_larger_batch_grows_its_slot():
    """A slot is sized to the first batch it holds and re-allocated only for a larger one."""
    rng = np.random.default_rng(3)
    card, stats = FakeCard(), {}
    ring = StagingRing(2, card.alloc, card.transfer, stats)
    sizes = [4, 4, 16, 4, 16, 16]  # slot 0 takes 4, 16, 16; slot 1 takes 4, 4, 16
    placed = []
    for B in sizes:
        b = _batch(rng, B=B, Lw=10)
        placed.append((ring.place(b, True), b))
    assert stats["feed_ring_grows"] == 2  # slot 0 at the third batch, slot 1 at the sixth
    assert len(card.slots) == 4 and stats["feed_staged"] == 6
    # 16 x 10 words and 16 x 5 validity words, each rounded up to 64 elements (256 B)
    assert [s.numel() for s in ring.slots] == [192 + 128] * 2
    for g, b in placed:
        _same(g, _want(b))


def test_a_slot_in_flight_is_not_refilled_until_its_transfer_completes():
    """The refill waits on the slot's event, and the ring counts the wait and its seconds."""
    rng = np.random.default_rng(4)
    card, stats = FakeCard(lazy=True, sync_s=0.02), {}
    ring = StagingRing(2, card.alloc, card.transfer, stats)
    a, b, c, d = (_batch(rng) for _ in range(4))
    pa, pb = ring.place(a, True), ring.place(b, True)
    ea, eb = card.events
    assert not ea.done and not eb.done and (pa.words == -1).all()
    pc = ring.place(c, True)  # slot 0 again: waits on a's transfer, then refills
    ec = card.events[2]
    assert ea.synced and stats["feed_ring_waits"] == 1
    waited = stats["feed_ring_wait"]
    assert 0.02 <= waited < 1.0
    _same(pa, _want(a))  # a's copy landed from the slot before c overwrote it
    eb.complete()  # b's transfer done: its slot is refilled without a wait
    ring.place(d, True)
    assert not eb.synced and stats["feed_ring_waits"] == 1
    assert stats["feed_ring_wait"] == waited
    _same(pb, _want(b))
    ec.synchronize()
    _same(pc, _want(c))


def test_each_segment_starts_256_byte_aligned():
    """The arrays of a batch are contiguous views of one buffer, each 256-B aligned in it."""
    rng = np.random.default_rng(5)
    card = FakeCard()
    ring = StagingRing(3, card.alloc, card.transfer)
    for B, Lw, pv in ((3, 5, False), (7, 3, True), (1, 1, False), (5, 10, True)):
        b = _batch(rng, B=B, Lw=Lw, prefix_valid=pv)
        width, placed = ring.place((B, b), True)
        shipped = [t for t in (placed.words, placed.vwords, placed.length)
                   if isinstance(t, torch.Tensor)]
        assert width == B and len(shipped) == 2
        base = shipped[0].untyped_storage().data_ptr()
        for t in shipped:
            assert t.is_contiguous() and t.untyped_storage().data_ptr() == base
            assert (t.data_ptr() - base) % 256 == 0
        assert shipped[0].data_ptr() == base
        _same(placed, _want(b))


def _feed_threads():
    return [t for t in threading.enumerate() if t.name == "denovo-kmer-prefetch"]


@pytest.mark.parametrize("how", ["early_close", "producer_error"])
def test_closing_the_feed_frees_the_ring_and_its_threads(how):
    rng = np.random.default_rng(6)
    before = len(_feed_threads())
    card = FakeCard()

    def batches():
        for i in range(1000):
            if how == "producer_error" and i == 5:
                raise KeyError("decode failed")
            yield _batch(rng)

    feed = card.feed(batches())
    got = []
    if how == "early_close":
        got += [next(feed), next(feed)]
        feed.close()
    else:
        with pytest.raises(KeyError):
            for b in feed:  # every batch decoded before the error arrives first
                got.append(b)
    assert len(got) == (2 if how == "early_close" else 5)
    assert all(isinstance(b, PackedReads) for b in got)
    assert card.slots and all(ref() is None for ref in card.slots)
    deadline = time.monotonic() + 5.0
    while len(_feed_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(_feed_threads()) == before


@pytest.fixture(scope="module")
def trio_paths(tmp_path_factory):
    trio = make_trio(TrioSpec(genome_len=2000, read_len=60, coverage=6.0, seed=5,
                              n_inherited_snvs=4, n_denovo_snvs=2, n_rate=0.002))
    return write_trio_bams(trio, str(tmp_path_factory.mktemp("ring_trio")))


def test_ring_tallies_land_in_the_calls_metrics(trio_paths, monkeypatch):
    """A feed through the ring reports ``feed_staged`` (every batch), ``feed_ring_waits``,
    ``feed_ring_wait``, ``feed_ring_grows`` and ``feed_place_cpu`` in the running call's
    Metrics; a CPU feed reports none of them, and the two reports are equal."""
    cfg = EngineConfig(k=21, max_read_len=64, batch_reads=16, table_capacity=1 << 13)
    paths = (trio_paths["mom"], trio_paths["dad"], trio_paths["child"])
    plain = Metrics()
    want = pipeline.run_trio(*paths, cfg, plain, device="cpu")
    for name in ("feed_staged", "feed_ring_waits", "feed_ring_grows"):
        assert name not in plain.counters
    for name in ("feed_ring_wait", "feed_place_cpu"):
        assert name not in plain.seconds

    def ringed(batches, device=None, depth=2, decode_depth=2, put=None,
               ship_lengths=False, stats=None):
        return FakeCard().feed(batches, depth, ship_lengths, stats)

    monkeypatch.setattr(pipeline, "prefetch_placed", ringed)
    m = Metrics()
    cpu0 = time.thread_time()
    got = pipeline.run_trio(*paths, cfg, m, device="cpu")
    cpu = time.thread_time() - cpu0
    assert got.report == want.report and got.tables_n == want.tables_n
    assert m.counters["feed_staged"] == m.counters["batches"] == plain.counters["batches"]
    assert m.counters["feed_ring_grows"] == 0 and "feed_ring_waits" in m.counters
    assert "feed_ring_wait" in m.seconds
    # the placements ran on this thread, inside the call: a part of its CPU time
    assert 0 <= m.seconds["feed_place_cpu"] <= cpu


def test_the_cpu_and_put_feeds_keep_no_ring_tallies():
    rng = np.random.default_rng(7)
    batches = [_batch(rng, prefix_valid=i % 2 == 0) for i in range(4)]
    for kw in (dict(device="cpu"), dict(put=as_int32_tensor)):
        stats = {}
        got = list(prefetch_placed(iter(batches), ship_lengths=True, stats=stats, **kw))
        for g, b in zip(got, batches):
            _same(g, _want(b))
        m = Metrics()
        pipeline._report_feed_stats(m, stats)
        assert stats["items"] == 4 and "feed_staged" not in stats
        assert "feed_staged" not in m.counters and "feed_place_cpu" not in m.seconds


@pytest.mark.parametrize("placement", ["put", "ring"])
def test_the_feed_wait_holds_the_placement_on_the_callers_thread(placement):
    """Every feed places on the caller's thread, and ``consumer_wait_s`` (the call's
    ``feed_wait``) holds each placement: here 10 ms a batch behind a decode that never
    keeps the caller waiting."""
    rng = np.random.default_rng(9)
    batches = [_batch(rng) for _ in range(6)]
    card, stats = FakeCard(transfer_s=0.01), {}

    def put(a):
        card.threads.add(threading.current_thread())
        time.sleep(0.01 / 2)  # two arrays a batch
        return as_int32_tensor(a)

    if placement == "put":
        feed = prefetch_placed(iter(batches), put=put, stats=stats)
    else:
        feed = card.feed(iter(batches), ship_lengths=False, stats=stats)
    got = []
    for b in feed:
        got.append(b)
        time.sleep(0.01)  # the decode thread refills the queue meanwhile
    assert card.threads == {threading.current_thread()}
    assert stats["items"] == len(got) == 6
    assert stats["consumer_wait_s"] >= 6 * 0.01
    for g, b in zip(got, batches):
        _same(g, _want(b, ship_lengths=False))


@pytest.mark.cuda
def test_the_card_ring_places_200_random_batches_bitwise():
    """200 batches of random shapes and bits through a 2-slot ring on the card, a consumer
    that sleeps between batches and keeps the last few placed, each compared bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU tests above drive the same ring)")
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(8)
    sleeps = random.Random(8)
    batches = [_batch(rng, B=int(rng.integers(1, 4096)), Lw=int(rng.integers(1, 11)),
                      prefix_valid=bool(rng.integers(0, 2))) for _ in range(200)]
    stats = {}
    ring = StagingRing(2, *_cuda_ring_parts(device), stats)
    feed = _feed(iter(batches), functools.partial(ring.place, ship_lengths=True), 3, stats, ring)
    kept = []
    for got, b in zip(feed, batches):
        assert got.words.device == device
        _same(got, _want(b))
        kept = (kept + [(got, b)])[-5:]  # held past the next batches' placement
        time.sleep(sleeps.random() * 0.002)
    torch.cuda.synchronize()
    for got, b in kept:
        _same(got, _want(b))
    assert stats["feed_staged"] == 200 and stats["feed_ring_grows"] > 0
