"""Trio de novo candidate rule over three tables, and its compacted candidate set.

Port of ``denovo_kmer_tpu/ops/trio.py``: the child's unique k-mers are joined against both
parental tables (``ops.join.join_tables_on_child``), flagged by SPEC_SEMANTICS §6, and the
flagged rows are compacted to the front in k-mer order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from denovo_kmer_tpu_torch.ops.table import KmerTable, u32


class Candidates(NamedTuple):
    """Compacted candidate set: first ``n`` rows are real, in ascending k-mer order."""

    keys: torch.Tensor  # (C, W) int64 uint32 values
    child_counts: torch.Tensor  # (C,) int64
    mom_counts: torch.Tensor  # (C,) int64
    dad_counts: torch.Tensor  # (C,) int64
    n: torch.Tensor  # () int64


def candidate_flags(
    child: KmerTable,
    mom: KmerTable,
    dad: KmerTable,
    tau_parent: int,
    min_child_count: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parental counts of every child unique k-mer → (flags, mom_counts, dad_counts)."""
    from denovo_kmer_tpu_torch.ops.join import join_tables_on_child

    _, child_counts, mom_counts, dad_counts, child_valid = join_tables_on_child(child, mom, dad)
    flags = (
        child_valid
        & (child_counts >= min_child_count)
        & (mom_counts <= tau_parent)
        & (dad_counts <= tau_parent)
    )
    return flags, mom_counts, dad_counts


def call_candidates(
    child: KmerTable,
    mom: KmerTable,
    dad: KmerTable,
    tau_parent: int,
    min_child_count: int,
) -> Candidates:
    """Flag, then compact the flagged rows to the front by one stable sort: the child table
    is sorted, so each block stays in k-mer order (the report order of SPEC_SEMANTICS §7)."""
    flags, mom_counts, dad_counts = candidate_flags(
        child, mom, dad, tau_parent, min_child_count
    )
    order = torch.argsort((~flags).to(torch.int8), stable=True)
    return Candidates(
        keys=u32(child.keys[order]),
        child_counts=u32(child.counts[order]),
        mom_counts=mom_counts[order],
        dad_counts=dad_counts[order],
        n=flags.sum(),
    )
