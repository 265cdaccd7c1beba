"""Per-block stable bucket partition: the port of the Pallas radix-partition kernel.

``radix_partition_blocks`` keeps the contract of
``denovo_kmer_tpu/ops/partition_pallas.py:radix_partition_blocks``: ``data`` (C, N) uint32
bits with the row index along N, ``ids`` (N,) bucket ids; it returns ``out`` (C, N) in which
each ``block_lanes`` slice is bucket-major and stable within a bucket, and ``counts``
(N // block_lanes, n_buckets) int32, with the same ``ValueError``s. ``partition_spill_blocks``
is the spill's entry into the same kernel: any ``n_buckets`` up to ``MAX_SPILL_BUCKETS`` and a
ragged last block.

On CUDA tensors both launch the hand-written kernel ``csrc/radix_partition.cu`` (counted in
``partition_kernel.launches``); on CPU tensors they run ``partition_blocks_plain``. There is
no fallback from one to the other. ``data`` may be any strided view, e.g. ``acc.kmers.T``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

#: the kernel's shared-memory counts hold (16 warps + 3) rows of this many int32 buckets
MAX_SPILL_BUCKETS = 1024
#: ctypes parameter kinds of ``dk_radix_partition`` in ``csrc/radix_partition.cu``
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def partition_blocks_plain(data: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                           block_lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: per block, a stable sort of the ids, a gather of the rows and a
    count per bucket. A ragged last block is padded with ids past every bucket, which sort
    last and are cut off. Ids at or above ``n_buckets`` count as the last bucket, as in the
    kernel."""
    C, N = data.shape
    dev = data.device
    G = -(-N // block_lanes)
    pad = G * block_lanes - N
    b = ids.to(torch.int64).clamp(max=n_buckets - 1)
    b = torch.cat([b, torch.full((pad,), n_buckets, dtype=torch.int64, device=dev)])
    b = b.view(G, block_lanes)
    order = torch.sort(b, dim=1, stable=True).indices
    base = torch.arange(G, dtype=torch.int64, device=dev)[:, None] * block_lanes
    src = (order + base).reshape(-1)[:N]
    out = data[:, src]
    flat = (b + torch.arange(G, device=dev)[:, None] * (n_buckets + 1)).reshape(-1)
    counts = torch.bincount(flat, minlength=G * (n_buckets + 1)).view(G, n_buckets + 1)
    return out, counts[:, :n_buckets].to(torch.int32)


def _kernel_library() -> ctypes.CDLL:
    from denovo_kmer_tpu_torch.utils.cuda_build import load

    lib = load("radix_partition")
    if lib.dk_radix_partition.argtypes is None:
        lib.dk_radix_partition.argtypes = _ARGTYPES
        lib.dk_radix_partition.restype = ctypes.c_int
    return lib


def partition_kernel(data: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                     block_lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/radix_partition.cu`` on CUDA tensors: ``data`` (C, N) int32 of any
    strides, ``ids`` (N,) int32 or int64 in [0, n_buckets)."""
    C, N = data.shape
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"partition_kernel takes CUDA tensors, got {dev}")
    if data.dtype != torch.int32:
        raise TypeError(f"data must be int32 (uint32 bits), got {data.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if not 1 <= n_buckets <= MAX_SPILL_BUCKETS:
        raise ValueError(f"n_buckets ({n_buckets}) must be in [1, {MAX_SPILL_BUCKETS}]")
    ids = ids.to(torch.int32).contiguous()
    G = -(-N // block_lanes)
    out = torch.empty((C, N), dtype=torch.int32, device=dev)
    counts = torch.empty((G, n_buckets), dtype=torch.int32, device=dev)
    if N == 0:
        return out, counts
    err = _kernel_library().dk_radix_partition(
        data.data_ptr(), data.stride(0), data.stride(1), C, ids.data_ptr(), N,
        block_lanes, n_buckets, out.data_ptr(), counts.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"radix_partition kernel launch failed: CUDA error {err}")
    partition_kernel.launches += 1
    return out, counts


partition_kernel.launches = 0


def _partition(data, ids, n_buckets, block_lanes):
    if data.dim() != 2 or ids.shape != (data.shape[1],):
        raise ValueError(f"data must be (C, N) and ids (N,), got {tuple(data.shape)} and "
                         f"{tuple(ids.shape)}")
    if ids.device != data.device:
        raise ValueError(f"ids are on {ids.device}, data on {data.device}")
    if block_lanes < 1:
        raise ValueError(f"block_lanes ({block_lanes}) must be >= 1")
    if data.device.type == "cuda":
        return partition_kernel(data, ids, n_buckets, block_lanes)
    return partition_blocks_plain(data, ids, n_buckets, block_lanes)


def radix_partition_blocks(data: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                           block_lanes: int = 32768) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block stable n_buckets-way partition (the JAX contract). N must divide by
    block_lanes and n_buckets must be a power of two no larger than 128.

    Returns (out (C, N) — each block_lanes slice bucket-major — and counts
    (N // block_lanes, n_buckets) int32)."""
    C, N = data.shape
    if N % block_lanes:
        raise ValueError(f"N ({N}) % block_lanes ({block_lanes}) != 0")
    nbits = (n_buckets - 1).bit_length()
    if 1 << nbits != n_buckets:
        raise ValueError(f"n_buckets ({n_buckets}) must be a power of two")
    if n_buckets > 128:
        raise ValueError(f"n_buckets ({n_buckets}) > 128 (one counts lane row)")
    return _partition(data, ids, n_buckets, block_lanes)


def partition_spill_blocks(data: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                           block_lanes: int = 32768) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spill's entry: as ``radix_partition_blocks``, but ``n_buckets`` is any count in
    [1, MAX_SPILL_BUCKETS] and the last block may be ragged (counts has
    ceil(N / block_lanes) rows)."""
    if not 1 <= n_buckets <= MAX_SPILL_BUCKETS:
        raise ValueError(f"n_buckets ({n_buckets}) exceeds the partition kernel's "
                         f"{MAX_SPILL_BUCKETS}-bucket histogram (at most "
                         f"{MAX_SPILL_BUCKETS - 1} passes)")
    return _partition(data, ids, n_buckets, block_lanes)
