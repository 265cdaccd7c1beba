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
(counted in ``block_sort.launches``; the kernel's entry picks the CTA's columns from the
block height), and runs ``block_sort_plain`` on CPU tensors. There is no fallback from one
to the other. No pipeline calls it: it is a probe of sort costs, driven by
``chip_smoke.py`` at the Pallas probe's shape (2^22 x 128, 2048-row blocks).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

#: XOR with the sign bit maps unsigned order onto signed int32 order
_FLIP = -(1 << 31)
#: the tallest block the kernel has an instance for (csrc/block_sort.cu, kMaxLogR): a column
#: is held in the registers of a team of at most one CTA
MAX_BLOCK_ROWS = 1 << 14
#: ctypes parameter kinds of ``dk_block_sort`` in ``csrc/block_sort.cu``
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    if block_rows < 2 or block_rows & (block_rows - 1) or block_rows > MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows ({block_rows}) must be a power of two from 2 to "
                         f"{MAX_BLOCK_ROWS}")
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


def _kernel_library() -> ctypes.CDLL:
    from denovo_kmer_tpu_torch.utils.cuda_build import load

    lib = load("block_sort")
    if lib.dk_block_sort.argtypes is None:
        lib.dk_block_sort.argtypes = _ARGTYPES
        lib.dk_block_sort.restype = ctypes.c_int
    return lib


def _launch(keys, pays, out_keys, out_pays, block_rows, info) -> None:
    dev = keys.device
    N, L = keys.shape
    err = _kernel_library().dk_block_sort(
        keys.data_ptr(), pays.data_ptr(), out_keys.data_ptr(), out_pays.data_ptr(), N, L,
        block_rows, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream, info)
    if err != 0:
        raise RuntimeError(f"block_sort kernel launch failed: CUDA error {err}")


def block_sort(keys: torch.Tensor, pays: torch.Tensor,
               block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each column of each (block_rows, L) block of (N, L) int32 ``keys`` by unsigned
    key, ``pays`` alongside; returns new (keys, pays). CUDA tensors launch
    ``csrc/block_sort.cu``, CPU tensors run ``block_sort_plain``."""
    _check(keys, pays, block_rows)
    if keys.device.type != "cuda":
        return block_sort_plain(keys, pays, block_rows)
    out_keys = torch.empty_like(keys)
    out_pays = torch.empty_like(pays)
    _launch(keys, pays, out_keys, out_pays, block_rows, None)
    block_sort.launches += 1
    return out_keys, out_pays


block_sort.launches = 0


def kernel_resources(keys: torch.Tensor, block_rows: int) -> Dict[str, int]:
    """What the kernel instance for (N, L) CUDA ``keys`` at this block height uses, from the
    CUDA runtime (nothing launches): registers and spilled (local) bytes a thread, CTAs
    resident on an SM, threads, shared bytes and columns a CTA."""
    _check(keys, keys, block_rows)
    info = (ctypes.c_int * 6)()
    _launch(keys, keys, keys, keys, block_rows, ctypes.addressof(info))
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "threads", "smem_bytes",
                     "columns"), info))
