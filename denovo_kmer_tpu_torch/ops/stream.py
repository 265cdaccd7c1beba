"""LSM-style streaming table build: O(extract) per batch, amortized sort on flush.

Port of ``denovo_kmer_tpu/ops/stream.py``. Raw extracted k-mers are appended to a device
staging buffer (no sort, no sync), and only every ``accum_batches`` batches does one flush
aggregate+merge run. Everything stays exact: the flush aggregates with the same
``_aggregate`` as the direct path.

The staging buffer is written IN PLACE (the JAX package donates it to the jitted step
instead): ``append`` and the extraction kernel (``ops.extract.extract_append``) fill rows
``[fill, fill + rows)`` of the same tensors and return an accumulator with a larger
``fill``, and ``flush`` hands the same tensors back with ``fill = 0``. Staged keys are int32
tensors holding the uint32 key words' bits; ``fill`` is a host int, known from the schedule.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from denovo_kmer_tpu_torch.ops.table import (
    KmerTable,
    _aggregate,
    _sticky_overflow_n,
    u32,
)


class KmerAccumulator(NamedTuple):
    """Staging buffer of raw (unaggregated) k-mers awaiting a flush."""

    kmers: torch.Tensor  # (S, W) int32 — uint32 key words, bit for bit
    valid: torch.Tensor  # (S,) bool
    fill: int  # slots used

    @property
    def slots(self) -> int:
        return self.kmers.shape[0]


def empty_accumulator(slots: int, words: int, device="cpu") -> KmerAccumulator:
    return KmerAccumulator(
        kmers=torch.zeros((slots, words), dtype=torch.int32, device=device),
        valid=torch.zeros((slots,), dtype=torch.bool, device=device),
        fill=0,
    )


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values → int32 tensor with the same 32 bits."""
    return (x & 0xFFFFFFFF).to(torch.int32)


def append(acc: KmerAccumulator, kmers: torch.Tensor, valid: torch.Tensor) -> KmerAccumulator:
    """Append one batch's raw k-mers ((..., W) uint32 values + mask) in place. Raises if the
    batch does not fit (the schedule flushes every accum_batches appends)."""
    W = acc.kmers.shape[1]
    flat = kmers.reshape(-1, W)
    n = flat.shape[0]
    if acc.fill + n > acc.slots:
        raise ValueError(f"staging overflow: {acc.fill} + {n} rows > {acc.slots} slots")
    acc.kmers[acc.fill : acc.fill + n] = to_int32_bits(flat)
    acc.valid[acc.fill : acc.fill + n] = valid.reshape(-1)
    return acc._replace(fill=acc.fill + n)


def staged_valid(acc: KmerAccumulator) -> torch.Tensor:
    """Valid mask of the staged rows, rows at or past ``fill`` cleared."""
    slot = torch.arange(acc.slots, device=acc.valid.device)
    return acc.valid & (slot < acc.fill)


def flush(acc: KmerAccumulator, table: KmerTable) -> Tuple[KmerAccumulator, KmerTable]:
    """Aggregate the staging buffer and merge it into the table; reset the buffer.

    One sort over (S + C) rows via concat-aggregate: table entries join the sort as
    pre-weighted rows, so flush is a single ``_aggregate`` call.
    """
    C = table.capacity
    S = acc.slots
    kmers = torch.cat([table.keys, u32(acc.kmers)], dim=0)
    weights = torch.cat(
        [table.counts, torch.ones((S,), dtype=torch.int64, device=table.counts.device)]
    )
    tslot = torch.arange(C, device=table.keys.device)
    valid = torch.cat([tslot < table.n, staged_valid(acc)])
    new_table = _aggregate(kmers, weights, valid, C)
    # overflow is sticky across flushes: a past drop must surface at the final host check
    new_table = new_table._replace(n=_sticky_overflow_n(new_table.n, C, table.n > C))
    return acc._replace(fill=0), new_table
