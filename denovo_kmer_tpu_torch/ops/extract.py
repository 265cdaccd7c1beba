"""Canonical k-mer extraction fused with the staging append.

``extract_append`` is the port of the JAX ingest step's extract + append
(``denovo_kmer_tpu/pipeline.py:make_ingest_step``): on CUDA tensors it launches the
hand-written kernel ``csrc/extract_kmers.cu`` (which replaces the Pallas kernel
``denovo_kmer_tpu/ops/extract_pallas.py:_extract_kernel``), and on CPU tensors it runs the
plain version below. There is no fallback from one to the other.

``extract_canonical_kmers`` and ``vwords_from_lengths`` are the plain version: a
line-for-line torch transcription of ``denovo_kmer_tpu/ops/extract_fast.py``. With
``n_passes > 1`` both keep only windows whose ``router.pass_of`` bucket is ``pass_id``, the
pass filter of the JAX multipass step. uint32 words
are carried in int64 and masked with ``0xFFFFFFFF`` after every left shift (torch has no
uint32 shifts on the CPU); right shifts of non-negative values need no mask.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from denovo_kmer_tpu_torch.config import words_per_kmer
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, append
from denovo_kmer_tpu_torch.ops.table import u32
from denovo_kmer_tpu_torch.parallel.router import pass_of

_M32 = 0xFFFFFFFF
#: ctypes parameter kinds of ``dk_extract_kmers_append`` in ``csrc/extract_kmers.cu``
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _reverse_2bit_fields(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 16 2-bit fields within each uint32 (int64-carried)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M32) | (x >> 16)


def vwords_from_lengths(lengths: torch.Tensor, padded_len: int) -> torch.Tensor:
    """Validity words of a prefix-valid batch from its read lengths: bit j of word w is 1
    iff 32*w + j < length — exactly ``ops.pack._pack_codes``' vwords when the batch is
    prefix-valid. Returns int64 uint32 values (B, padded_len // 32)."""
    V = padded_len // 32
    base = torch.arange(V, dtype=torch.int64, device=lengths.device)[None, :] * 32
    rem = (lengths.to(torch.int64)[:, None] - base).clamp(0, 32)
    return torch.where(rem >= 32, _M32, (torch.ones_like(rem) << rem) - 1)


def extract_canonical_kmers(
    words: torch.Tensor,
    vwords: torch.Tensor,
    k: int,
    max_read_len: int,
    canonical: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed reads → (kmers (B, P, W) int64 uint32 big-endian words, valid (B, P) bool).

    ``words`` (B, Lp/16) and ``vwords`` (B, Lp/32) may hold the uint32 bits as int32 or the
    values as int64. Keys of invalid windows are unspecified (the append masks them)."""
    words = u32(words)
    vwords = u32(vwords)
    dev = words.device
    B, Lw = words.shape
    L = Lw * 16
    P = max_read_len - k + 1
    W = words_per_kmer(k)
    R = 32 * W - 2 * k  # right-shift aligning the window to 2k bits
    pad = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)

    mw = torch.cat([_reverse_2bit_fields(words), pad], dim=1)  # big-endian stream
    cw = torch.cat([words ^ _M32, pad], dim=1)  # complemented LE stream

    # per-position phase shifts broadcast over B
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    sh = (2 * (pos % 16))[None, :]  # 2p
    shc = (31 - 2 * (pos % 16))[None, :]  # 31-2p

    def rep(a: torch.Tensor, w: int) -> torch.Tensor:
        # column i of the result = a[:, i//16 + w]
        return a[:, w : w + Lw + 1].repeat_interleave(16, dim=1)[:, :P]

    # forward: 32W-bit MSB-first window starting at base i, then >> R
    win = []
    for w in range(W):
        hi = (rep(mw, w) << sh) & _M32
        lo = (rep(mw, w + 1) >> 1) >> shc  # == >> (32-2p), safe at p=0
        win.append(hi | lo)
    if R == 0:
        fwd = win
    else:
        fwd = [win[0] >> R]
        for w in range(1, W):
            fwd.append((win[w] >> R) | ((win[w - 1] << (32 - R)) & _M32))

    # reverse-complement: little-endian field starting at bit 2i of the complemented stream
    rc_le = []
    for w in range(W):
        lo = rep(cw, w) >> sh
        hi = ((rep(cw, w + 1) << 1) << (31 - sh)) & _M32  # == << (32-2p), safe at p=0
        rc_le.append(lo | hi)
    u = 2 * k - 32 * (W - 1)  # bits used in the top word
    if u < 32:
        rc_le[W - 1] = rc_le[W - 1] & ((1 << u) - 1)
    rc = rc_le[::-1]  # big-endian word order

    if canonical:
        lt = torch.zeros((B, P), dtype=torch.bool, device=dev)
        eq = torch.ones((B, P), dtype=torch.bool, device=dev)
        for w in range(W):
            lt = lt | (eq & (fwd[w] < rc[w]))
            eq = eq & (fwd[w] == rc[w])
        use_fwd = lt | eq
        out = [torch.where(use_fwd, f, r) for f, r in zip(fwd, rc)]
    else:
        out = fwd

    # validity: no invalid base among the k in the window (exclusive prefix sum)
    bit = (torch.arange(L, dtype=torch.int64, device=dev) % 32)[None, :]
    vbits = (vwords.repeat_interleave(32, dim=1) >> bit) & 1
    inv = vbits ^ 1
    csum = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int64, device=dev), torch.cumsum(inv, dim=1)],
        dim=1,
    )
    win_valid = (csum[:, k : k + P] - csum[:, :P]) == 0
    return torch.stack(out, dim=-1), win_valid


def append_plain(
    acc: KmerAccumulator,
    words: torch.Tensor,
    vwords: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor],
    k: int,
    max_read_len: int,
    canonical: bool = True,
    n_passes: int = 1,
    pass_id: int = 0,
) -> KmerAccumulator:
    """The plain version of ``extract_append``: extraction, the pass filter, then the
    staging append."""
    if vwords is None:
        vwords = vwords_from_lengths(lengths, words.shape[1] * 16)
    kmers, valid = extract_canonical_kmers(words, vwords, k, max_read_len, canonical)
    if n_passes > 1:
        valid = valid & (pass_of(kmers, n_passes) == pass_id)
    return append(acc, kmers, valid)


def _kernel_library() -> ctypes.CDLL:
    from denovo_kmer_tpu_torch.utils.cuda_build import load

    lib = load("extract_kmers")
    if lib.dk_extract_kmers_append.argtypes is None:
        lib.dk_extract_kmers_append.argtypes = _ARGTYPES
        lib.dk_extract_kmers_append.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _chunk_words(k: int) -> int:
    """Stream words ``csrc/extract_kmers.cu`` takes of a read at once with 32 lanes a read:
    lane j holds word j of the chunk, and a window of the chunk reads W + 1 words from its
    first, so the chunk and the W + 1 words past it fit 32 lanes. Even, so that a chunk
    starts on a whole validity word (32 bases)."""
    return (31 - words_per_kmer(k)) & ~1


@functools.lru_cache(maxsize=None)
def _lanes_per_read(Lw: int, k: int, P: int) -> int:
    """Lanes of a warp that ``csrc/extract_kmers.cu`` gives a read, 32 or 16, each lane a
    window a step. 16 lanes (two reads a warp) need a read's words and the W + 1 a window
    reads past its first to fit them, and are taken where they need at most 3/4 of the warp
    steps of 32 lanes: a read of 34 windows (64 bases, k = 31) takes 3 half-warp steps in
    place of 2 whole-warp ones that leave 30 of 64 lanes idle. On the card 16 lanes lost
    where they save less (130 windows: 4.5 against 5 warp steps; PERF.md, Findings)."""
    if Lw + words_per_kmer(k) + 1 > 16:
        return 32
    return 16 if 2 * -(-P // 16) <= 3 * -(-P // 32) else 32


def _check(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bits), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the staging buffer on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def extract_append(
    acc: KmerAccumulator,
    words: torch.Tensor,
    vwords: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor],
    k: int,
    max_read_len: int,
    canonical: bool = True,
    n_passes: int = 1,
    pass_id: int = 0,
) -> KmerAccumulator:
    """Extract every window of a packed batch and append it to the staging buffer.

    ``words`` (B, Lp/16) int32, and either ``vwords`` (B, Lp/32) int32 or, for a
    length-shipped batch (``vwords=None``), ``lengths`` (B,) int32. Rows
    ``[fill, fill + B*P)`` of ``acc`` receive window (b, p) at ``fill + b*P + p``; with
    ``n_passes > 1`` a window is valid only if its pass bucket is ``pass_id``. Returns
    the accumulator with the larger ``fill``. CUDA tensors launch the kernel (counted in
    ``extract_append.launches``); CPU tensors run ``append_plain``.
    """
    dev = acc.kmers.device
    B, Lw = words.shape
    P = max_read_len - k + 1
    W = words_per_kmer(k)
    if P < 1 or Lw * 16 < max_read_len:
        raise ValueError(f"bad geometry: k={k}, max_read_len={max_read_len}, Lp={Lw * 16}")
    if acc.kmers.shape[1] != W:
        raise ValueError(f"staging holds {acc.kmers.shape[1]}-word keys, k={k} needs {W}")
    if acc.fill + B * P > acc.slots:
        raise ValueError(f"staging overflow: {acc.fill} + {B * P} rows > {acc.slots} slots")
    if not 0 <= pass_id < n_passes:
        raise ValueError(f"pass_id {pass_id} outside [0, {n_passes})")
    _check(words, "words", (B, Lw), dev)
    if vwords is not None:
        _check(vwords, "vwords", (B, Lw // 2), dev)
    else:
        if lengths is None:
            raise ValueError("a batch needs vwords or lengths")
        _check(lengths, "lengths", (B,), dev)
    if dev.type != "cuda":
        return append_plain(acc, words, vwords, lengths, k, max_read_len, canonical,
                            n_passes, pass_id)
    if acc.kmers.dtype != torch.int32 or acc.valid.dtype != torch.bool:
        raise TypeError("staging buffer must be int32 keys and bool valid")
    if acc.kmers.data_ptr() % 16:
        raise ValueError("the kernel stores key rows as 8- and 16-byte vectors: the staging "
                         "keys must start 16-byte aligned")
    if B == 0:
        return acc

    lib = _kernel_library()
    err = lib.dk_extract_kmers_append(
        words.data_ptr(), B, Lw,
        vwords.data_ptr() if vwords is not None else None, Lw // 2,
        lengths.data_ptr() if vwords is None else None,
        k, P, int(bool(canonical)), n_passes, pass_id, _chunk_words(k),
        _lanes_per_read(Lw, k, P),
        acc.kmers.data_ptr(), acc.valid.data_ptr(), acc.fill,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"extract_kmers kernel launch failed: CUDA error {err}")
    extract_append.launches += 1
    return acc._replace(fill=acc.fill + B * P)


extract_append.launches = 0
