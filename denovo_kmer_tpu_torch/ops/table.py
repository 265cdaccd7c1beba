"""Device k-mer table: sorted multi-word keys + counts, static capacity.

Port of ``denovo_kmer_tpu/ops/table.py``. The table is a sorted array of W-word keys with a
parallel count vector; a build is sort + segment-aggregate, probes are vectorized
branch-free binary searches. Rows that are already sorted and unique (a table, a row
partial) are merged into a table (``_merge_sorted``); only unsorted rows are sorted
(``_staged_groups``, ``_aggregate_parts``).

Representation: key words and counts are int32 tensors holding the uint32 values' bits, so a
``KmerTable`` row costs 4W+4 B as the JAX package's does (torch has no uint32 arithmetic).
Unsigned compares and sums widen through ``u32`` (int64 values 0..2^32-1) where they run;
sums are taken in int64 and wrapped with ``& 0xFFFFFFFF`` — the uint32 arithmetic of the JAX
package — before they are stored as 32 bits again. ``n`` is a 0-dim
int64 tensor on the table's device, read on the host only where the JAX package reads it.

Invariants (as in the JAX package):
- ``keys[:n]``  valid entries, strictly increasing in lexicographic word order
- ``keys[n:]``  padding = all 0xFFFFFFFF, ``counts[n:] = 0``
- lexicographic word order == integer order on the 2k-bit value (SPEC_SEMANTICS §2.1)
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.table_merge import merge_rows
from denovo_kmer_tpu_torch.utils.device import resolve_device
from denovo_kmer_tpu_torch.utils.metrics import span, tally

PAD = 0xFFFFFFFF
_PAD_BITS = -1  # PAD as an int32 bit pattern
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding uint32 bits (int32 bit patterns or int64 values) → int64
    tensor of the uint32 values."""
    return x.to(torch.int64) & _M32


def _host_bits(a: np.ndarray) -> torch.Tensor:
    """A CPU int32 tensor viewing the bits of a host uint32 array (no copy where the array
    is already contiguous uint32). JAX hands out read-only arrays; the port never writes a
    table in place, so torch's warning about them does not apply."""
    bits = np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(bits)


class KmerTable(NamedTuple):
    keys: torch.Tensor  # (C, W) int32 — uint32 key words, bit for bit; sorted, padding last
    counts: torch.Tensor  # (C,) int32 — uint32 counts, bit for bit
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
        keys=torch.full((capacity, words), _PAD_BITS, dtype=torch.int32, device=device),
        counts=torch.zeros((capacity,), dtype=torch.int32, device=device),
        n=torch.zeros((), dtype=torch.int64, device=device),
    )


def table_from_numpy(keys: np.ndarray, counts: np.ndarray, n: int, device=None) -> KmerTable:
    """A table on ``device`` (``None``: the card) from host arrays: uint32 (C, W) keys,
    uint32 (C,) counts and the int ``n`` — what ``np.asarray`` gives of a JAX
    ``KmerTable``'s leaves. On the CPU the tensors view the arrays' bits (no copy)."""
    device = resolve_device(device)
    return KmerTable(
        keys=_host_bits(keys).to(device),
        counts=_host_bits(counts).to(device),
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
    return _part_sort_keys(list(words), None)


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


def _pad_sort_keys(W: int) -> List[int]:
    """``sort_keys`` of the all-ones (padding) key of W words: the largest value each key
    takes, so the padding sorts last."""
    return ([PAD] if W % 2 else []) + [(1 << 63) - 1] * (W // 2)


def _part_sort_keys(rows, valid) -> List[torch.Tensor]:
    """``sort_keys`` of a block of key rows ((n, W) int64 uint32 values or int32 bits, or a
    list of W word columns), rows where ``valid`` is False (None: every row is valid) set
    to the padding's keys. Built in place: at most three (n,) int64 temporaries live."""
    cols = list(rows) if isinstance(rows, (list, tuple)) else [rows[:, w]
                                                              for w in range(rows.shape[1])]
    W = len(cols)
    keys = [u32(cols[0])] if W % 2 else []
    for j in range(W % 2, W, 2):
        key = u32(cols[j])
        key <<= 32
        key |= u32(cols[j + 1])
        key ^= _SIGN
        keys.append(key)
    if valid is not None:
        for key, pad in zip(keys, _pad_sort_keys(W)):
            key.masked_fill_(~valid, pad)
    return keys


def _unpack_sort_keys(keys: Sequence[torch.Tensor], W: int) -> List[torch.Tensor]:
    """The W uint32 word columns (int64) of ``sort_keys`` values (inverse of ``sort_keys``)."""
    words = [keys[0]] if W % 2 else []
    for key in keys[W % 2:]:
        key = key ^ _SIGN
        words += [(key >> 32) & _M32, key & _M32]
    return words


def _filled(parts, N: int, col: int, dev) -> torch.Tensor:
    """Weight column ``col`` of ``parts`` as one (N,) int64 tensor of uint32 values, 0 on
    invalid rows; a part's weight is a (n,) tensor (uint32 values, or int32 bits) or an int
    for every row."""
    out = torch.empty((N,), dtype=torch.int64, device=dev)
    at = 0
    for rows, valid, weights in parts:
        n = _rows_shape(rows)[0]
        w = weights[col]
        seg = out[at:at + n]
        if isinstance(w, torch.Tensor):
            seg.copy_(w)
            if w.dtype != torch.int64:
                seg &= _M32
        else:
            seg.fill_(w)
        if valid is not None:
            seg.masked_fill_(~valid, 0)
        at += n
    return out


def _rows_shape(rows) -> Tuple[int, int]:
    """(n, W) of a block of key rows: an (n, W) tensor or a list of W (n,) columns."""
    if isinstance(rows, (list, tuple)):
        return rows[0].shape[0], len(rows)
    return rows.shape[0], rows.shape[1]


def _rows_device(rows) -> torch.device:
    return (rows[0] if isinstance(rows, (list, tuple)) else rows).device


def _sorted_groups(parts):
    """One key sort over the rows of ``parts`` ((rows, valid, weights) blocks, see
    ``_part_sort_keys``): → (sorted sort keys, the permutation, the sorted row where each
    group of equal keys starts, ascending). Invalid rows carry the padding key, so they
    sort last. One host sync (the group count). Memory: the (N,) int64 sort key (two for
    W > 2), the sort's output, permutation and scratch; nothing of width W. The running
    call's tally ``rows_sorted`` counts the N rows; its span ``table.sort`` holds the
    sort(s)."""
    N = sum(_rows_shape(rows)[0] for rows, _v, _w in parts)
    keys = None
    at = 0
    for rows, valid, _w in parts:
        part = _part_sort_keys(rows, valid)
        if keys is None:
            keys = [torch.empty((N,), dtype=torch.int64, device=part[0].device)
                    for _ in part]
        n = part[0].shape[0]
        for key, pk in zip(keys, part):
            key[at:at + n] = pk
        del part
        at += n
    tally("rows_sorted", N)
    with span("table.sort", keys[0].device):
        s_keys, perm = _lex_sort(keys)
    starts = torch.nonzero(group_heads(s_keys)).squeeze(1)
    return s_keys, perm, starts


def _lex_sort(keys: List[torch.Tensor], with_perm: bool = True):
    """Sort by ``keys`` (one or two (N,) int64 sort keys, most significant first; the list
    is emptied) → (sorted keys, permutation, or None without ``with_perm`` where two keys
    are sorted). Two keys (W = 3, 4) take ``lex_argsort``'s two stable sorts, each key
    dropped once it is used — sort the low key, carry the high key into that order,
    stable-sort it — so at most five (N,) int64 columns live beside one sort's scratch."""
    if len(keys) == 1:
        s_key, perm = torch.sort(keys.pop(), stable=True)
        return [s_key], perm
    hi, lo = keys
    keys.clear()
    s_lo, perm = torch.sort(lo, stable=True)
    del lo
    hi = hi[perm]
    s_hi, order = torch.sort(hi, stable=True)
    del hi
    perm = perm[order] if with_perm else None
    s_lo = s_lo[order]
    return [s_hi, s_lo], perm


def _staged_groups(rows: torch.Tensor, valid: torch.Tensor):
    """Sort one block of staged key rows ((N, W) int32 bits, see ``_part_sort_keys``) and
    reduce it to its unique keys, each with its run length: every valid row weighs 1, and
    invalid rows take the padding key and weigh 0, so they join a real all-ones k-mer's
    group or form one weight-0 group that is dropped, as in ``_aggregate_parts``. → (keys
    (U, W) int32, counts (U,) int32, n: a 0-dim int64 tensor, U less the dropped group).

    One W <= 2 key sorts without a permutation (``torch.unique``, which also takes the run
    lengths); two keys (W = 3, 4) take ``_lex_sort``'s two stable sorts. One host sync (U).
    The running call's tally ``rows_sorted`` counts the N rows; its span ``table.sort``
    holds the sort(s)."""
    N, W = rows.shape
    dev = rows.device
    if N == 0:
        return (torch.empty((0, W), dtype=torch.int32, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    keys = _part_sort_keys(rows, valid)
    tally("rows_sorted", N)
    counts = None
    with span("table.sort", dev):
        if len(keys) == 1:
            s_key, counts = torch.unique(keys.pop(), sorted=True, return_counts=True)
            s_keys = [s_key]
        else:
            s_keys, _ = _lex_sort(keys, with_perm=False)
    if counts is None:
        starts = torch.nonzero(group_heads(s_keys)).squeeze(1)
        counts = torch.diff(starts, append=starts.new_full((1,), N))
        s_keys = [k[starts] for k in s_keys]
        del starts
    U = counts.shape[0]
    is_pad = torch.ones((), dtype=torch.bool, device=dev)
    for k, pad in zip(s_keys, _pad_sort_keys(W)):
        is_pad &= k[-1] == pad
    counts[-1:] -= torch.where(is_pad, N - valid.sum(), 0)
    n = U - (is_pad & (counts[-1] == 0)).to(torch.int64)
    out = torch.empty((U, W), dtype=torch.int32, device=dev)
    for w, col in enumerate(_unpack_sort_keys(s_keys, W)):
        out[:, w] = col
    return out, counts.to(torch.int32), n


def _merge_sorted(a_keys, a_n, a_cols, b_keys, b_n, b_cols, capacity: int):
    """``ops/table_merge.merge_rows`` of two sorted unique row sets → (keys, weight columns,
    n), inside the running call's span ``table.merge``; its tally ``rows_merged`` adds the
    valid rows the merge reads (a 0-dim tensor on the device: no host sync)."""
    with span("table.merge", a_keys.device):
        keys, cols, n, rows = merge_rows(a_keys, a_n, a_cols, b_keys, b_n, b_cols, capacity)
    tally("rows_merged", rows)
    return keys, cols, n


def _group_sums(parts, col: int, perm, starts, take: int, N: int):
    """Sums of weight column ``col`` over the first ``take`` groups and over the last group,
    wrapped to 32 bits: prefix differences of an int64 scan of the column in sorted
    order."""
    dev = perm.device
    g = _filled(parts, N, col, dev)[perm]
    g.cumsum_(0)
    st = starts[:take]
    en = torch.cat([starts[1:take + 1],
                    torch.full((1,), N, dtype=torch.int64, device=dev)])[:take]
    before = g[(st - 1).clamp(min=0)]
    before[st == 0] = 0
    sums = (g[en - 1] - before) & _M32
    last0 = starts[-1:]
    last = (g[N - 1:] - torch.where(last0 > 0, g[(last0 - 1).clamp(min=0)], 0)) & _M32
    return sums, last[0]


def _aggregate_parts(parts, capacity: int):
    """Sort the rows of ``parts`` ((rows, valid, weights) blocks; see ``_part_sort_keys``
    and ``_filled``) by key, group equal keys and sum each weight column per group.

    Returns (keys (capacity, W), cols [(capacity,) ...], n), keys and columns as int32 bits
    of the uint32 values: the same result as the JAX ``_aggregate_multi`` over the
    concatenated blocks. Invalid rows take the all-ones key with weight 0, so they sort
    last and either join a real all-ones k-mer's group (adding 0) or form one weight-0
    group that is stripped; group sums are prefix differences taken
    in int64 and wrapped to 32 bits, which equals JAX's uint32 prefix differences. ``n`` is
    the true unique count; if it exceeds ``capacity`` the overflow groups are dropped
    (callers check host-side). The rows are never concatenated: the sort runs on one int64
    key a row, and the output keys are unpacked from the sorted keys."""
    n_cols = len(parts[0][2])
    N = sum(_rows_shape(rows)[0] for rows, _v, _w in parts)
    W = _rows_shape(parts[0][0])[1]
    if N == 0:
        t = empty_table(capacity, W, _rows_device(parts[0][0]))
        return t.keys, [t.counts.clone() for _ in range(n_cols)], t.n
    s_keys, perm, starts = _sorted_groups(parts)
    dev = perm.device
    U = starts.shape[0]
    take = min(U, capacity)
    out_keys = torch.full((capacity, W), _PAD_BITS, dtype=torch.int32, device=dev)
    for w, col in enumerate(_unpack_sort_keys([k[starts[:take]] for k in s_keys], W)):
        out_keys[:take, w] = col
    # strip the all-zero-weight all-ones last group formed by invalid rows (if any); a
    # *real* all-ones k-mer group has some weight >= 1 and is kept. A stripped group's
    # row already reads as padding (all-ones key, weights 0).
    strip = torch.ones((), dtype=torch.bool, device=dev)
    for k, pad in zip(s_keys, _pad_sort_keys(W)):
        strip &= k[N - 1] == pad
    del s_keys
    cols = []
    for c in range(n_cols):
        sums, last = _group_sums(parts, c, perm, starts, take, N)
        col = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        col[:take] = sums  # int64 uint32 values stored as their 32 bits
        cols.append(col)
        strip &= last == 0
    n_unique = U - strip.to(torch.int64)
    return out_keys, cols, n_unique


def _aggregate_multi(
    kmers: torch.Tensor,  # (N, W) uint32 words: int32 bits or int64 values
    weight_cols: Sequence[torch.Tensor],  # (N,) uint32 values or bits — summed per group
    valid: torch.Tensor,  # (N,) bool
    capacity: int,
):
    """Sort (invalid-last), group equal keys, sum each weight column per group: the JAX
    ``_aggregate_multi`` (see ``_aggregate_parts``, of one block). Returns (keys (capacity,
    W), cols [(capacity,) ...], n)."""
    return _aggregate_parts([(kmers, valid, list(weight_cols))], capacity)


def build_table(kmers: torch.Tensor, valid: torch.Tensor, capacity: int) -> KmerTable:
    """Build a table from a k-mer stream; each valid k-mer contributes count 1."""
    keys, cols, n = _aggregate_parts(
        [(kmers.reshape(-1, kmers.shape[-1]), valid.reshape(-1), [1])], capacity)
    return KmerTable(keys=keys, counts=cols[0], n=n)


def _sticky_overflow_n(n_out, capacity: int, *input_overflows):
    """Overflow drops rows silently inside an aggregate and a LATER one would recompute
    ``n`` from the survivors, masking the loss — so once any input has overflowed its own
    capacity, pin the output ``n`` above ``capacity`` so the host-side check always fires."""
    sticky = torch.zeros((), dtype=torch.bool, device=n_out.device)
    for ov in input_overflows:
        sticky = sticky | ov
    return torch.where(sticky, n_out.clamp(min=capacity + 1), n_out)


def valid_rows(n: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.arange(capacity, device=n.device) < n


def merge_tables(a: KmerTable, b: KmerTable, capacity: int) -> KmerTable:
    """Merge two tables (count addition) into a table of the given capacity: both are
    sorted and unique, so one ``_merge_sorted``; an overflow of either input stays sticky."""
    keys, cols, n = _merge_sorted(a.keys, a.n, [a.counts], b.keys, b.n, [b.counts], capacity)
    return KmerTable(keys=keys, counts=cols[0],
                     n=_sticky_overflow_n(n, capacity, a.n > a.capacity, b.n > b.capacity))


def ingest_batch(table: KmerTable, kmers: torch.Tensor, valid: torch.Tensor,
                 accumulate_kmers_capacity: int) -> KmerTable:
    """One incremental-build step: aggregate a batch and merge it into the running table."""
    batch_tab = build_table(kmers, valid, accumulate_kmers_capacity)
    return merge_tables(table, batch_tab, table.capacity)


def _lex_less(a_words, b_words) -> torch.Tensor:
    """Row-wise unsigned lexicographic ``a < b`` over word columns (uint32 values or int32
    bits): a word at or above 2^31 orders after one below it."""
    lt = torch.zeros(a_words[0].shape, dtype=torch.bool, device=a_words[0].device)
    eq = torch.ones(a_words[0].shape, dtype=torch.bool, device=a_words[0].device)
    for aw, bw in zip(a_words, b_words):
        aw, bw = u32(aw), u32(bw)
        lt = lt | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return lt


def probe_table(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Vectorized lower-bound binary search: queries (..., W) uint32 values or int32 bits →
    counts (...,) int64 uint32 values.

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
    found_k = u32(table.keys[idx])
    hit = torch.ones((N,), dtype=torch.bool, device=q.device)
    for w in range(W):
        hit = hit & (found_k[:, w] == q[:, w])
    hit = hit & (lo < C) & (lo < table.n)
    out = torch.where(hit, u32(table.counts[idx]), 0)
    return out.reshape(queries.shape[:-1])
