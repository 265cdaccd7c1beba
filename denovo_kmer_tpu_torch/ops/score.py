"""Parent-seeded scoring table: the trio call fused into the child LSM build.

Port of ``denovo_kmer_tpu/ops/score.py``. The child's streaming aggregation runs over a table
PRE-SEEDED with every parental key, carrying a second weight column ``pcounts`` that packs
the parental counts (mom in bits 0..15, dad in bits 16..31, saturated at 0xFFFF), so the
candidate call is one elementwise flag pass plus one compaction over the final table.

Exactness: each parental key appears exactly once per parent table, so the per-group sum of
``pcounts`` reconstructs (min(mom,0xFFFF) | min(dad,0xFFFF)<<16) exactly. The candidate rule
compares parental counts against tau_parent < 0xFFFF (config-validated), where saturation is
invisible.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, staged_valid
from denovo_kmer_tpu_torch.ops.table import (
    KmerTable,
    _aggregate_multi,
    _sticky_overflow_n,
    u32,
    valid_rows,
)
from denovo_kmer_tpu_torch.ops.trio import Candidates

_SAT = 0xFFFF


class ScoreTable(NamedTuple):
    """Sorted (keys, child counts, packed parental counts), padding last, like KmerTable."""

    keys: torch.Tensor  # (C, W) int64 uint32 values
    counts: torch.Tensor  # (C,) int64 — child occurrence counts (uint32 values)
    pcounts: torch.Tensor  # (C,) int64 — min(mom,0xFFFF) | min(dad,0xFFFF) << 16
    n: torch.Tensor  # () int64

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def score_table_from_numpy(keys: np.ndarray, counts: np.ndarray, pcounts: np.ndarray,
                           n: int, device="cpu") -> ScoreTable:
    """A scoring table from host uint32 arrays and the int ``n`` (a JAX ScoreTable's
    leaves through ``np.asarray``)."""
    def dev64(a):
        return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)).to(device)

    return ScoreTable(keys=dev64(keys), counts=dev64(counts), pcounts=dev64(pcounts),
                      n=torch.tensor(int(n), dtype=torch.int64, device=device))


def score_table_to_numpy(tab: ScoreTable) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(uint32 (C, W) keys, uint32 counts, uint32 pcounts, int n) on the host."""
    def host32(t):
        return t.cpu().numpy().astype(np.uint32)

    return host32(tab.keys), host32(tab.counts), host32(tab.pcounts), int(tab.n)


def seed_score_table(mom: KmerTable, dad: KmerTable, capacity: int) -> ScoreTable:
    """Union of the parental tables as a scoring table: child counts 0, pcounts packed."""
    keys = torch.cat([mom.keys, dad.keys])
    zeros = torch.zeros((keys.shape[0],), dtype=torch.int64, device=keys.device)
    pc = torch.cat([mom.counts.clamp(max=_SAT), dad.counts.clamp(max=_SAT) << 16])
    valid = torch.cat([valid_rows(mom.n, mom.capacity), valid_rows(dad.n, dad.capacity)])
    k, cols, n = _aggregate_multi(keys, [zeros, pc], valid, capacity)
    return ScoreTable(keys=k, counts=cols[0], pcounts=cols[1], n=n)


def flush_score(
    acc: KmerAccumulator, tab: ScoreTable, out_capacity: int = 0
) -> Tuple[KmerAccumulator, ScoreTable]:
    """Aggregate the raw-k-mer staging buffer into the scoring table; reset the buffer.

    Identical structure to ``ops.stream.flush`` with the pcounts column riding along
    (staged raw k-mers contribute pcounts 0; seeded rows carry the parental packs).
    ``out_capacity`` (default: same as input) lets a pipeline seed at a tight
    |mom ∪ dad| capacity and grow to the full table capacity on the first flush."""
    C = tab.capacity
    S = acc.slots
    dev = tab.keys.device
    kmers = torch.cat([tab.keys, u32(acc.kmers)])
    cnt_col = torch.cat([tab.counts, torch.ones((S,), dtype=torch.int64, device=dev)])
    pc_col = torch.cat([tab.pcounts, torch.zeros((S,), dtype=torch.int64, device=dev)])
    valid = torch.cat([valid_rows(tab.n, C), staged_valid(acc)])

    cap_out = out_capacity or C
    k, cols, n = _aggregate_multi(kmers, [cnt_col, pc_col], valid, cap_out)
    # overflow is sticky across flushes (see table.merge_tables)
    n = _sticky_overflow_n(n, cap_out, tab.n > C)
    return acc._replace(fill=0), ScoreTable(keys=k, counts=cols[0], pcounts=cols[1], n=n)


def check_call_args(tau_parent: int, min_child_count: int) -> None:
    if not 0 <= tau_parent < 0xFFFF:
        raise ValueError("tau_parent must fit the 16-bit saturated pack")
    if min_child_count < 1:
        raise ValueError("min_child_count < 1 would report parent-only seed rows")


def call_from_score(tab: ScoreTable, tau_parent: int, min_child_count: int) -> Candidates:
    """Candidate call over a finished scoring table: elementwise flags + one stable
    compaction sort (flagged rows first, each block in key order).

    Same rule as SPEC_SEMANTICS §6: child count >= min_child_count and BOTH parental
    counts <= tau_parent. Parent-only seeded rows have child count 0 and are excluded by
    min_child_count >= 1 (config-validated).
    """
    check_call_args(tau_parent, min_child_count)
    momc = tab.pcounts & _SAT
    dadc = tab.pcounts >> 16
    flags = (
        valid_rows(tab.n, tab.capacity)
        & (tab.counts >= min_child_count)
        & (momc <= tau_parent)
        & (dadc <= tau_parent)
    )
    order = torch.argsort((~flags).to(torch.int8), stable=True)
    return Candidates(
        keys=tab.keys[order],
        child_counts=tab.counts[order],
        mom_counts=momc[order],
        dad_counts=dadc[order],
        n=flags.sum(),
    )
