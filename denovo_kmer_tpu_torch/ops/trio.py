"""Compacted trio candidate set (port of ``Candidates`` in ``denovo_kmer_tpu/ops/trio.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Candidates(NamedTuple):
    """Compacted candidate set: first ``n`` rows are real, in ascending k-mer order."""

    keys: torch.Tensor  # (C, W) int64 uint32 values
    child_counts: torch.Tensor  # (C,) int64
    mom_counts: torch.Tensor  # (C,) int64
    dad_counts: torch.Tensor  # (C,) int64
    n: torch.Tensor  # () int64
