"""Standalone canonical k-mer extraction: packed reads → (kmers (B, P, W), valid (B, P)).

Port of ``denovo_kmer_tpu/ops/extract_fast.py``. On CUDA tensors
``extract_canonical_kmers_fast`` launches the hand-written kernel ``csrc/extract_kmers.cu``,
the counterpart of the Pallas ``extract_canonical_kmers_pallas``
(``denovo_kmer_tpu/ops/extract_pallas.py:131``, itself a drop-in for the JAX function of
this name): ``ops.extract.extract_append`` writes every window into a fresh buffer of B·P
rows, window (b, p) at row b·P + p, so the result is a reshape. On CPU tensors it runs the
plain version, ``ops.extract.extract_canonical_kmers``. Either way keys are int64 tensors of
uint32 values, and keys of invalid windows are unspecified.
"""

from __future__ import annotations

from typing import Tuple

import torch

from denovo_kmer_tpu_torch.config import words_per_kmer
from denovo_kmer_tpu_torch.ops.extract import (
    extract_append,
    extract_canonical_kmers,
    vwords_from_lengths,
)
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, to_int32_bits
from denovo_kmer_tpu_torch.ops.table import u32

__all__ = ["vwords_from_lengths", "extract_canonical_kmers_fast",
           "extract_canonical_kmers_fast_t"]


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """The kernel's input: a contiguous int32 tensor of the uint32 bits."""
    if x.dtype != torch.int32:
        x = to_int32_bits(x.to(torch.int64))
    return x.contiguous()


def extract_canonical_kmers_fast(
    words: torch.Tensor,
    vwords: torch.Tensor,
    k: int,
    max_read_len: int,
    canonical: bool = True,
    barrier: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed reads → (kmers (B, P, W) int64 uint32 big-endian words, valid (B, P) bool).

    ``words`` (B, Lp/16) and ``vwords`` (B, Lp/32) hold the uint32 bits as int32 or the
    values as int64. On the card one launch of the extraction kernel (counted in
    ``extract_append.launches``), the counterpart of ``extract_canonical_kmers_pallas``
    (``denovo_kmer_tpu/ops/extract_pallas.py:131``); on the CPU the plain version.
    ``barrier`` is XLA's fusion barrier in the JAX package and has no effect here."""
    if words.device.type != "cuda":
        return extract_canonical_kmers(words, vwords, k, max_read_len, canonical)
    B = words.shape[0]
    P = max(max_read_len - k + 1, 0)
    W = words_per_kmer(k)
    acc = KmerAccumulator(
        kmers=torch.empty((B * P, W), dtype=torch.int32, device=words.device),
        valid=torch.empty((B * P,), dtype=torch.bool, device=words.device),
        fill=0,
    )
    acc = extract_append(acc, _int32_bits(words), _int32_bits(vwords), None, k,
                         max_read_len, canonical)
    return u32(acc.kmers).reshape(B, P, W), acc.valid.reshape(B, P)


def extract_canonical_kmers_fast_t(
    words: torch.Tensor,
    vwords: torch.Tensor,
    k: int,
    max_read_len: int,
    canonical: bool = True,
    barrier: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed layout of ``extract_canonical_kmers_fast``: ``kmers (P, B, W)`` and
    ``valid (P, B)``, the same windows. (The JAX package computes it in this layout for the
    TPU's lanes; here it is the same extraction, transposed.)"""
    kmers, valid = extract_canonical_kmers_fast(words, vwords, k, max_read_len, canonical,
                                                barrier)
    return kmers.transpose(0, 1).contiguous(), valid.t().contiguous()
