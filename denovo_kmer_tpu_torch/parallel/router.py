"""Hash router: k-mer → owner shard or hash pass, and capacity-bounded bucketing.

Port of ``denovo_kmer_tpu/parallel/router.py``. Ownership and the multi-pass partition use a
mixed hash, not the raw top bits (canonicalization skews values low): FNV-1a over the words,
then the murmur3 finalizer. The same function runs everywhere, so partitioning never changes
results.

uint32 words are carried in int64 and masked with ``0xFFFFFFFF``. A product of two 32-bit
values does not fit an int64, so every multiply splits its constant into 16-bit halves
(``_mul32``): each partial product stays below 2^49.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64-carried uint32 ``h`` and a 32-bit constant ``c``."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(kmers: torch.Tensor, basis: int = 0x811C9DC5) -> torch.Tensor:
    """(N, W) uint32 k-mer words (int32 bits or int64 values) → (N,) int64 well-mixed hash
    in [0, 2^32) (FNV-1a + murmur3 fmix32)."""
    words = kmers.to(torch.int64) & _M32
    h = torch.full(words.shape[:-1], basis, dtype=torch.int64, device=words.device)
    for w in range(words.shape[-1]):
        h = _mul32(h ^ words[..., w], 0x01000193)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def owner_of(kmers: torch.Tensor, num_shards: int) -> torch.Tensor:
    """(N, W) → (N,) int32 owner shard in [0, num_shards)."""
    return (mix32(kmers) % num_shards).to(torch.int32)


def pass_of(kmers: torch.Tensor, n_passes: int) -> torch.Tensor:
    """(N, W) → (N,) int64 multi-pass bucket in [0, n_passes). A different FNV basis than
    ``owner_of`` keeps the pass partition independent of the shard partition."""
    return mix32(kmers, basis=0x9E3779B9) % n_passes


def route_capacity(n_kmers: int, num_shards: int, factor: float) -> int:
    """Per-(src,dst) dispatch capacity: even split × factor, 8-aligned, ≥8."""
    cap = int(-(-n_kmers * factor // num_shards))
    return max(-(-cap // 8) * 8, 8)


def bucketize(
    kmers: torch.Tensor,  # (N, W) uint32 words (int32 bits or int64 values)
    valid: torch.Tensor,  # (N,) bool
    num_shards: int,
    capacity: int,
    owner: torch.Tensor = None,  # (N,) precomputed bucket ids (default owner_of)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group k-mers into per-destination buckets: one stable sort by owner, per-owner
    segment starts by ``searchsorted``, and a clamped gather into the (T, capacity) layout.

    Returns (dispatch (T, cap, W) in ``kmers``' dtype, mask (T, cap) bool, src (T, cap)
    int32, overflow () int64). ``src[t, c]`` is the original row of that slot (-1 where
    masked); within a bucket rows keep their original order. Rows past ``capacity`` in a
    bucket are counted in ``overflow``, never silently lost.
    """
    N, W = kmers.shape
    T = num_shards
    dev = kmers.device
    if owner is None:
        owner = owner_of(kmers, T)
    owner = torch.where(valid, owner.to(torch.int64), T)  # invalid → virtual shard T
    s_owner, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(s_owner, torch.arange(T + 1, dtype=torch.int64, device=dev))
    count = start[1:] - start[:-1]
    take_n = count.clamp(max=capacity)
    overflow = (count - take_n).sum()
    c_iota = torch.arange(capacity, dtype=torch.int64, device=dev)[None, :]
    src_idx = (start[:-1, None] + c_iota).clamp(max=max(N - 1, 0))  # JAX mode="clip"
    mask = c_iota < take_n[:, None]
    if N == 0:
        disp = torch.zeros((T, capacity, W), dtype=kmers.dtype, device=dev)
        src = torch.full((T, capacity), -1, dtype=torch.int32, device=dev)
        return disp, mask, src, overflow
    rows = order[src_idx]  # (T, cap) original row of each slot
    disp = kmers[rows]
    src = torch.where(mask, rows, -1).to(torch.int32)
    return disp, mask, src, overflow
