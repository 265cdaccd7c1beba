"""Merge of two sorted, unique row sets into a table, weights added.

A ``KmerTable`` or ``ScoreTable`` is sorted and unique by invariant, so a table step that
folds new rows into it needs to sort only the new rows: ``merge_rows`` then folds the two
sorted sets together. Each side is (keys (cap, W) int32 — uint32 words, bit for bit —, n,
weight columns): its first ``n`` rows (clamped to ``[0, cap]``; ``n`` a 0-dim int64 tensor
on the keys' device) are valid and strictly ascending in unsigned lexicographic word order.
Each side has the same number of weight columns (1 or 2): (cap,) int32 tensors of uint32
bits, or None for a column of zeros. The result is the first ``capacity`` rows of the union
in key order, a key of both sides taking the sum of its weights wrapped to 32 bits, then
padding (all-ones keys, weights 0), and ``n``: the union's size, even above ``capacity``,
less one where the union's last row is the all-ones key with every weight 0 — the row that
``ops/table._aggregate_parts`` strips as the invalid rows' group. The fourth result is the
valid rows read, the two clamped ``n`` summed (a 0-dim int64 tensor).

CUDA tensors launch the hand-written kernel ``csrc/table_merge.cu`` (counted in
``merge_kernel.launches``), CPU tensors run ``merge_rows_plain``. There is no fallback from
one to the other. Neither synchronizes with the host on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

#: merge positions a tile of the kernel (csrc/table_merge.cu, kTile): its scratch holds two
#: int64 words a tile
TILE = 1024
_PAD_BITS = -1
_M32 = 0xFFFFFFFF
#: ctypes parameter kinds of ``dk_table_merge`` in ``csrc/table_merge.cu``
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

Cols = Sequence[Optional[torch.Tensor]]
Merged = Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]


def _check(a_keys, a_n, a_cols: Cols, b_keys, b_n, b_cols: Cols, capacity: int) -> None:
    dev = a_keys.device
    if not 1 <= len(a_cols) == len(b_cols) <= 2:
        raise ValueError(f"both sides need the same 1 or 2 weight columns, got "
                         f"{len(a_cols)} and {len(b_cols)}")
    for side, keys, n, cols in (("a", a_keys, a_n, a_cols), ("b", b_keys, b_n, b_cols)):
        if keys.dtype != torch.int32 or keys.dim() != 2 or not keys.is_contiguous():
            raise ValueError(f"{side} keys must be contiguous (cap, W) int32, got "
                             f"{keys.dtype} {tuple(keys.shape)}")
        if n.dtype != torch.int64 or n.dim() != 0:
            raise ValueError(f"{side} n must be a 0-dim int64 tensor")
        for c in cols:
            if c is not None and (c.dtype != torch.int32 or c.shape != keys.shape[:1]
                                  or not c.is_contiguous()):
                raise ValueError(f"{side} weights must be contiguous ({keys.shape[0]},) "
                                 f"int32")
        for t in (keys, n, *(c for c in cols if c is not None)):
            if t.device != dev:
                raise ValueError(f"side {side}'s tensors are on {t.device}, side a's keys "
                                 f"on {dev}")
    if a_keys.shape[1] != b_keys.shape[1] or not 1 <= a_keys.shape[1] <= 4:
        raise ValueError(f"key widths {a_keys.shape[1]} and {b_keys.shape[1]} must agree, "
                         f"1 to 4 words")
    if capacity < 0:
        raise ValueError(f"capacity ({capacity}) must be >= 0")


def merge_rows_plain(a_keys, a_n, a_cols: Cols, b_keys, b_n, b_cols: Cols,
                     capacity: int) -> Merged:
    """The plain version: A's valid rows then B's, one stable lexicographic sort of their
    uint32 words (least significant word first), a group a key, each weight column summed
    into its group and wrapped to 32 bits."""
    dev = a_keys.device
    W = a_keys.shape[1]
    na = a_n.clamp(0, a_keys.shape[0])
    nb = b_n.clamp(0, b_keys.shape[0])
    ia, ib = int(na), int(nb)
    words = torch.cat([a_keys[:ia], b_keys[:ib]]).to(torch.int64) & _M32
    order = torch.arange(ia + ib, device=dev)
    for w in reversed(range(W)):
        order = order[torch.sort(words[order, w], stable=True).indices]
    s_words = words[order]
    head = torch.ones((ia + ib,), dtype=torch.bool, device=dev)
    head[1:] = (s_words[1:] != s_words[:-1]).any(dim=1)
    group = torch.cumsum(head, 0) - 1
    U = int(head.sum())
    take = min(U, capacity)
    out_keys = torch.full((capacity, W), _PAD_BITS, dtype=torch.int32, device=dev)
    out_keys[:take] = s_words[head][:take].to(torch.int32)
    sums = []
    for ca, cb in zip(a_cols, b_cols):
        vals = [torch.zeros((n,), dtype=torch.int64, device=dev) if c is None
                else c[:n].to(torch.int64) & _M32 for c, n in ((ca, ia), (cb, ib))]
        g = torch.zeros((U,), dtype=torch.int64, device=dev)
        g.index_add_(0, group, torch.cat(vals)[order])
        sums.append(g & _M32)
    cols = []
    for g in sums:
        col = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        col[:take] = g[:take].to(torch.int32)
        cols.append(col)
    strip = U > 0 and bool((s_words[-1] == _M32).all()) and all(int(g[-1]) == 0 for g in sums)
    n = torch.tensor(U - int(strip), dtype=torch.int64, device=dev)
    return out_keys, cols, n, na + nb


def _kernel_library() -> ctypes.CDLL:
    from denovo_kmer_tpu_torch.utils.cuda_build import load

    lib = load("table_merge")
    if lib.dk_table_merge.argtypes is None:
        lib.dk_table_merge.argtypes = _ARGTYPES
        lib.dk_table_merge.restype = ctypes.c_int
    return lib


def merge_kernel(a_keys, a_n, a_cols: Cols, b_keys, b_n, b_cols: Cols,
                 capacity: int) -> Merged:
    """Launch ``csrc/table_merge.cu`` on CUDA tensors (see the module's docstring)."""
    dev = a_keys.device
    if dev.type != "cuda":
        raise ValueError(f"merge_kernel takes CUDA tensors, got {dev}")
    W = a_keys.shape[1]
    nc = len(a_cols)
    out_keys = torch.empty((capacity, W), dtype=torch.int32, device=dev)
    out_cols = [torch.empty((capacity,), dtype=torch.int32, device=dev) for _ in range(nc)]
    out_n = torch.empty((), dtype=torch.int64, device=dev)
    tiles = -(-(a_keys.shape[0] + b_keys.shape[0]) // TILE)
    scratch = torch.empty((2 * tiles + 3,), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    a_c = [ptr(c) for c in a_cols] + [None] * (2 - nc)
    b_c = [ptr(c) for c in b_cols] + [None] * (2 - nc)
    o_c = [c.data_ptr() for c in out_cols] + [None] * (2 - nc)
    err = _kernel_library().dk_table_merge(
        a_keys.data_ptr(), a_n.data_ptr(), a_keys.shape[0], *a_c,
        b_keys.data_ptr(), b_n.data_ptr(), b_keys.shape[0], *b_c,
        out_keys.data_ptr(), *o_c, out_n.data_ptr(), capacity, W, nc,
        scratch.data_ptr(), scratch.shape[0],
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"table_merge kernel launch failed: CUDA error {err}")
    merge_kernel.launches += 1
    return out_keys, out_cols, out_n, scratch[-1]


merge_kernel.launches = 0


def merge_rows(a_keys, a_n, a_cols: Cols, b_keys, b_n, b_cols: Cols,
               capacity: int) -> Merged:
    """Merge side A and side B into a table of ``capacity`` rows → (keys (capacity, W),
    [weight columns (capacity,)], n, valid rows read): see the module's docstring. CUDA
    tensors launch ``csrc/table_merge.cu``, CPU tensors run ``merge_rows_plain``."""
    _check(a_keys, a_n, a_cols, b_keys, b_n, b_cols, capacity)
    if a_keys.device.type == "cuda":
        return merge_kernel(a_keys, a_n, a_cols, b_keys, b_n, b_cols, capacity)
    return merge_rows_plain(a_keys, a_n, a_cols, b_keys, b_n, b_cols, capacity)
