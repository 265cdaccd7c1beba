"""Per-block bitonic sort of every column by uint32 key, carrying a uint32 payload.

The port of the Pallas probe ``benchmarks/micro_pallas_sort.py:pallas_block_sort`` (its
``_kernel`` and network ``_bitonic_sort_block``): ``keys`` and ``pays`` are (N, L) int32
tensors holding uint32 bits; every block of ``block_rows`` consecutive rows has each of its
L columns sorted ascending by the UNSIGNED key, with the payload moved alongside. Both
versions run the TPU kernel's compare-exchange network stage for stage (direction from
``(row // size) & 1``, a swap when ``lo > hi`` strictly, XOR the direction), so ties resolve
as on the TPU and kernel, plain version and Pallas kernel agree bit for bit, payloads
included.

``block_sort`` launches the hand-written kernel ``csrc/block_sort.cu`` on CUDA tensors
(counted in ``block_sort.launches``) and runs ``block_sort_plain`` on CPU tensors. There is
no fallback from one to the other. No pipeline calls it: it is a probe of sort costs, driven
by ``chip_smoke.py`` at the Pallas probe's shape (2^22 x 128, 2048-row blocks).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

#: XOR with the sign bit maps unsigned order onto signed int32 order
_FLIP = -(1 << 31)
#: shared-memory budget of one CTA's tile (keys and payloads), as csrc/block_sort.cu takes it
_SMEM_TILE = 128 * 1024
#: ctypes parameter kinds of ``dk_block_sort`` in ``csrc/block_sort.cu``
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _check(keys: torch.Tensor, pays: torch.Tensor, block_rows: int) -> None:
    for name, t in (("keys", keys), ("pays", pays)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 bits), got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be (N, L), got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keys.shape != pays.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and pays {tuple(pays.shape)} differ")
    if keys.device != pays.device:
        raise ValueError(f"keys are on {keys.device}, pays on {pays.device}")
    if block_rows < 2 or block_rows & (block_rows - 1):
        raise ValueError(f"block_rows ({block_rows}) must be a power of two >= 2")
    N, L = keys.shape
    if N == 0 or L == 0 or N % block_rows:
        raise ValueError(f"N ({N}) must be a positive multiple of block_rows ({block_rows}) "
                         f"and L ({L}) positive")


def block_sort_plain(keys: torch.Tensor, pays: torch.Tensor,
                     block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the bitonic network on whole (G, R, L) tensors, one stage at a
    time, on sign-flipped keys so that int32 order is the unsigned order."""
    N, L = keys.shape
    R, G = block_rows, N // block_rows
    k = (keys ^ _FLIP).view(G, R, L)
    p = pays.view(G, R, L)
    rows = torch.arange(R, device=keys.device)
    size = 2
    while size <= R:
        s = size // 2
        while s >= 1:
            kk = k.view(G, R // (2 * s), 2, s, L)
            pp = p.view(G, R // (2 * s), 2, s, L)
            desc = ((rows.view(R // (2 * s), 2, s)[:, 0] // size) & 1).bool()
            swap = (kk[:, :, 0] > kk[:, :, 1]) ^ desc[None, :, :, None]
            k = torch.stack([torch.where(swap, kk[:, :, 1], kk[:, :, 0]),
                             torch.where(swap, kk[:, :, 0], kk[:, :, 1])], dim=2).view(G, R, L)
            p = torch.stack([torch.where(swap, pp[:, :, 1], pp[:, :, 0]),
                             torch.where(swap, pp[:, :, 0], pp[:, :, 1])], dim=2).view(G, R, L)
            s //= 2
        size *= 2
    return (k ^ _FLIP).view(N, L), p.reshape(N, L)


def block_lanes(block_rows: int, L: int) -> int:
    """Columns one CTA takes: as many as keep its tile within ``_SMEM_TILE``."""
    fit = _SMEM_TILE // (8 * block_rows)
    if fit < 1:
        raise ValueError(f"block_rows ({block_rows}) exceeds the kernel's shared-memory tile "
                         f"({_SMEM_TILE // 8} rows at most)")
    return min(L, fit)


def _kernel_library() -> ctypes.CDLL:
    from denovo_kmer_tpu_torch.utils.cuda_build import load

    lib = load("block_sort")
    if lib.dk_block_sort.argtypes is None:
        lib.dk_block_sort.argtypes = _ARGTYPES
        lib.dk_block_sort.restype = ctypes.c_int
    return lib


def block_sort(keys: torch.Tensor, pays: torch.Tensor,
               block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each column of each (block_rows, L) block of (N, L) int32 ``keys`` by unsigned
    key, ``pays`` alongside; returns new (keys, pays). CUDA tensors launch
    ``csrc/block_sort.cu``; CPU tensors run ``block_sort_plain``."""
    _check(keys, pays, block_rows)
    dev = keys.device
    if dev.type != "cuda":
        return block_sort_plain(keys, pays, block_rows)
    N, L = keys.shape
    lanes = block_lanes(block_rows, L)
    out_keys = torch.empty_like(keys)
    out_pays = torch.empty_like(pays)
    err = _kernel_library().dk_block_sort(
        keys.data_ptr(), pays.data_ptr(), out_keys.data_ptr(), out_pays.data_ptr(), N, L,
        block_rows, lanes, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"block_sort kernel launch failed: CUDA error {err}")
    block_sort.launches += 1
    return out_keys, out_pays


block_sort.launches = 0
