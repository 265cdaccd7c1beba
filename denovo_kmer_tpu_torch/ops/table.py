"""Device k-mer table: sorted multi-word keys + counts, static capacity.

Port of ``denovo_kmer_tpu/ops/table.py``. The table is a sorted array of W-word keys with a
parallel count vector; build/merge are sort + segment-aggregate, probes are vectorized
branch-free binary searches.

Representation: key words and counts are int64 tensors holding uint32 values (0..2^32-1),
so every comparison is the unsigned one and sums can be taken wide and wrapped with
``& 0xFFFFFFFF`` — the uint32 arithmetic of the JAX package. ``n`` is a 0-dim int64 tensor
on the table's device, read on the host only where the JAX package reads it.

Invariants (as in the JAX package):
- ``keys[:n]``  valid entries, strictly increasing in lexicographic word order
- ``keys[n:]``  padding = all 0xFFFFFFFF, ``counts[n:] = 0``
- lexicographic word order == integer order on the 2k-bit value (SPEC_SEMANTICS §2.1)
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.utils.device import resolve_device

PAD = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding uint32 bits (int32 bit patterns or int64 values) → int64
    tensor of the uint32 values."""
    return x.to(torch.int64) & _M32


class KmerTable(NamedTuple):
    keys: torch.Tensor  # (C, W) int64 uint32 values, sorted, padding last
    counts: torch.Tensor  # (C,) int64 uint32 values
    n: torch.Tensor  # () int64 — number of valid entries

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def words(self) -> int:
        return self.keys.shape[1]


def empty_table(capacity: int, words: int, device=None) -> KmerTable:
    """An empty table on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return KmerTable(
        keys=torch.full((capacity, words), PAD, dtype=torch.int64, device=device),
        counts=torch.zeros((capacity,), dtype=torch.int64, device=device),
        n=torch.zeros((), dtype=torch.int64, device=device),
    )


def table_from_numpy(keys: np.ndarray, counts: np.ndarray, n: int, device=None) -> KmerTable:
    """A table on ``device`` (``None``: the card) from host arrays: uint32 (C, W) keys,
    uint32 (C,) counts and the int ``n`` — what ``np.asarray`` gives of a JAX
    ``KmerTable``'s leaves."""
    device = resolve_device(device)
    return KmerTable(
        keys=torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)).to(device),
        counts=torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int64)).to(device),
        n=torch.tensor(int(n), dtype=torch.int64, device=device),
    )


def table_to_numpy(table: KmerTable) -> Tuple[np.ndarray, np.ndarray, int]:
    """(uint32 (C, W) keys, uint32 (C,) counts, int n) on the host."""
    return (
        table.keys.cpu().numpy().astype(np.uint32),
        table.counts.cpu().numpy().astype(np.uint32),
        int(table.n),
    )


def sort_keys(words: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """int64 sort keys, most significant first, whose lexicographic order is the unsigned
    lexicographic order of the uint32 ``words``: word pairs pack into one int64 as
    ``((hi << 32) | lo) ^ (1 << 63)`` (the sign flip keeps the all-ones padding LAST); an odd
    leading word stays a plain non-negative int64."""
    keys = []
    start = len(words) % 2
    if start:
        keys.append(words[0])
    for j in range(start, len(words), 2):
        keys.append(((words[j] << 32) | words[j + 1]) ^ _SIGN)
    return keys


def lex_argsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by ``keys`` (most significant first): one stable sort per
    key, least significant first, carrying the permutation."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        order = torch.argsort(k, stable=True)
        perm = order if perm is None else perm[order]
    return perm


def group_heads(s_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Head flags over a key-sorted stream of key columns (words or sort keys): row i
    starts a group iff any column differs from row i-1 (row 0 always does)."""
    N = s_words[0].shape[0]
    head = torch.zeros((N,), dtype=torch.bool, device=s_words[0].device)
    head[0] = True
    for k in s_words:
        head[1:] |= k[1:] != k[:-1]
    return head


def _aggregate_multi(
    kmers: torch.Tensor,  # (N, W) int64 uint32 values
    weight_cols: Sequence[torch.Tensor],  # (N,) int64 uint32 values — summed per group
    valid: torch.Tensor,  # (N,) bool
    capacity: int,
):
    """Sort (invalid-last), group equal keys, sum each weight column per group.

    Returns (keys (capacity, W), cols [(capacity,) ...], n). Same result as the JAX
    ``_aggregate_multi``: invalid rows become the all-ones key with weight 0, so they sort
    last and either join a real all-ones k-mer's group (adding 0) or form one weight-0 group
    that is stripped; group sums are prefix differences taken in int64 and wrapped to 32
    bits, which equals JAX's uint32 prefix differences. ``n`` is the true unique count; if
    it exceeds ``capacity`` the overflow groups are dropped (callers check host-side).
    """
    N, W = kmers.shape
    dev = kmers.device
    if N == 0:
        t = empty_table(capacity, W, dev)
        return t.keys, [t.counts.clone() for _ in weight_cols], t.n
    words = [torch.where(valid, kmers[:, w], PAD) for w in range(W)]
    wts = [torch.where(valid, wc, 0) for wc in weight_cols]
    keys = sort_keys(words)
    perm = lex_argsort(keys)
    s_keys = [k[perm] for k in keys]
    head = group_heads(s_keys)
    n_unique = head.sum()

    # starts[j] = sorted row where group j begins; N for every j >= n_unique, so that
    # group j spans [starts[j], starts[j+1]) for every j
    L = max(N, capacity)
    idx = torch.arange(N, device=dev)
    seg = torch.cumsum(head, 0) - 1
    starts = torch.full((L + 2,), N, dtype=torch.int64, device=dev)
    starts.index_copy_(0, torch.where(head, seg, L + 1), idx)
    starts = starts[: L + 1]
    first = starts[:L].clamp(max=N - 1)

    cols = []
    for wc in wts:
        csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(wc[perm], 0)])
        cols.append((csum[starts[1:]] - csum[starts[:-1]]) & _M32)
    out_words = [w[perm][first] for w in words]

    # strip the all-zero-weight all-ones tail group formed by invalid rows (if any); a
    # *real* all-ones k-mer group has some weight >= 1 and is kept
    last = (n_unique - 1).clamp(min=0).reshape(1)
    last_ones = torch.ones((1,), dtype=torch.bool, device=dev)
    for w in out_words:
        last_ones &= w.index_select(0, last) == PAD
    last_zero = torch.ones((1,), dtype=torch.bool, device=dev)
    for c in cols:
        last_zero &= c.index_select(0, last) == 0
    strip = (n_unique > 0) & last_ones[0] & last_zero[0]
    n_unique = n_unique - strip.to(torch.int64)

    in_range = torch.arange(capacity, device=dev) < n_unique.clamp(max=capacity)
    out_keys = torch.stack(
        [torch.where(in_range, w[:capacity], PAD) for w in out_words], dim=1
    )
    cols = [torch.where(in_range, c[:capacity], 0) for c in cols]
    return out_keys, cols, n_unique


def _aggregate(kmers, weights, valid, capacity: int) -> KmerTable:
    """Single-weight-column aggregation → KmerTable (see ``_aggregate_multi``)."""
    keys, cols, n = _aggregate_multi(kmers, [weights], valid, capacity)
    return KmerTable(keys=keys, counts=cols[0], n=n)


def build_table(kmers: torch.Tensor, valid: torch.Tensor, capacity: int) -> KmerTable:
    """Build a table from a k-mer stream; each valid k-mer contributes count 1."""
    flat = u32(kmers.reshape(-1, kmers.shape[-1]))
    v = valid.reshape(-1)
    ones = torch.ones((flat.shape[0],), dtype=torch.int64, device=flat.device)
    return _aggregate(flat, ones, v, capacity)


def _sticky_overflow_n(n_out, capacity: int, *input_overflows):
    """Overflow drops rows silently inside _aggregate and a LATER aggregate would recompute
    ``n`` from the survivors, masking the loss — so once any input has overflowed its own
    capacity, pin the output ``n`` above ``capacity`` so the host-side check always fires."""
    sticky = torch.zeros((), dtype=torch.bool, device=n_out.device)
    for ov in input_overflows:
        sticky = sticky | ov
    return torch.where(sticky, n_out.clamp(min=capacity + 1), n_out)


def valid_rows(n: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.arange(capacity, device=n.device) < n


def merge_tables(a: KmerTable, b: KmerTable, capacity: int) -> KmerTable:
    """Merge two tables (count addition) into a table of the given capacity."""
    keys = torch.cat([a.keys, b.keys])
    wts = torch.cat([a.counts, b.counts])
    valid = torch.cat([valid_rows(a.n, a.capacity), valid_rows(b.n, b.capacity)])
    out = _aggregate(keys, wts, valid, capacity)
    return out._replace(
        n=_sticky_overflow_n(out.n, capacity, a.n > a.capacity, b.n > b.capacity)
    )


def ingest_batch(table: KmerTable, kmers: torch.Tensor, valid: torch.Tensor,
                 accumulate_kmers_capacity: int) -> KmerTable:
    """One incremental-build step: aggregate a batch and merge it into the running table."""
    batch_tab = build_table(kmers, valid, accumulate_kmers_capacity)
    return merge_tables(table, batch_tab, table.capacity)


def _lex_less(a_words, b_words) -> torch.Tensor:
    lt = torch.zeros(a_words[0].shape, dtype=torch.bool, device=a_words[0].device)
    eq = torch.ones(a_words[0].shape, dtype=torch.bool, device=a_words[0].device)
    for aw, bw in zip(a_words, b_words):
        lt = lt | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return lt


def probe_table(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Vectorized lower-bound binary search: queries (..., W) uint32 values → counts (...,).

    Absent k-mers (and probes landing on padding) return 0, matching the oracle's
    ``table.get(K, 0)`` (SPEC_SEMANTICS §6). log2(C) rounds of branch-free compare/select;
    the probe index is clamped into the table as the JAX gather clamps it.
    """
    C, W = table.keys.shape
    q = u32(queries.reshape(-1, W))
    N = q.shape[0]
    qw = [q[:, w] for w in range(W)]
    lo = torch.zeros((N,), dtype=torch.int64, device=q.device)
    hi = torch.full((N,), C, dtype=torch.int64, device=q.device)
    for _ in range(max(C.bit_length(), 1)):
        mid = (lo + hi) >> 1
        mk = table.keys[mid.clamp(max=C - 1)]
        less = _lex_less([mk[:, w] for w in range(W)], qw)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    idx = lo.clamp(max=C - 1)
    found_k = table.keys[idx]
    hit = torch.ones((N,), dtype=torch.bool, device=q.device)
    for w in range(W):
        hit = hit & (found_k[:, w] == q[:, w])
    hit = hit & (lo < C) & (lo < table.n)
    out = torch.where(hit, table.counts[idx], 0)
    return out.reshape(queries.shape[:-1])
