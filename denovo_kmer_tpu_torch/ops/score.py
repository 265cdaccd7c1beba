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

from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator
from denovo_kmer_tpu_torch.ops.table import (
    KmerTable,
    _host_bits,
    _merge_sorted,
    _staged_groups,
    _sticky_overflow_n,
    empty_table,
    u32,
    valid_rows,
)
from denovo_kmer_tpu_torch.ops.trio import Candidates
from denovo_kmer_tpu_torch.utils.device import resolve_device
from denovo_kmer_tpu_torch.utils.metrics import span

_SAT = 0xFFFF


class ScoreTable(NamedTuple):
    """Sorted (keys, child counts, packed parental counts), padding last, like KmerTable:
    int32 tensors of the uint32 values' bits, 4W+8 B a row as in the JAX package."""

    keys: torch.Tensor  # (C, W) int32 — uint32 key words, bit for bit
    counts: torch.Tensor  # (C,) int32 — child occurrence counts (uint32 bits)
    pcounts: torch.Tensor  # (C,) int32 — min(mom,0xFFFF) | min(dad,0xFFFF) << 16 (bits)
    n: torch.Tensor  # () int64

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def score_table_from_numpy(keys: np.ndarray, counts: np.ndarray, pcounts: np.ndarray,
                           n: int, device=None) -> ScoreTable:
    """A scoring table on ``device`` (``None``: the card) from host uint32 arrays and the
    int ``n`` (a JAX ScoreTable's leaves through ``np.asarray``). On the CPU the tensors
    view the arrays' bits (no copy)."""
    device = resolve_device(device)
    return ScoreTable(keys=_host_bits(keys).to(device), counts=_host_bits(counts).to(device),
                      pcounts=_host_bits(pcounts).to(device),
                      n=torch.tensor(int(n), dtype=torch.int64, device=device))


def score_table_to_numpy(tab: ScoreTable) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(uint32 (C, W) keys, uint32 counts, uint32 pcounts, int n) on the host."""
    def host32(t):
        return t.cpu().numpy().astype(np.uint32)

    return host32(tab.keys), host32(tab.counts), host32(tab.pcounts), int(tab.n)


def empty_score_table(capacity: int, words: int, device=None) -> ScoreTable:
    """An empty scoring table on ``device`` (``None``: the card)."""
    t = empty_table(capacity, words, device)
    return ScoreTable(keys=t.keys, counts=t.counts, pcounts=t.counts.clone(), n=t.n)


def _sat16(counts: torch.Tensor) -> torch.Tensor:
    """min(count, 0xFFFF) of uint32 counts held as int32 bits (a negative bit pattern is a
    count at or above 2^31), in the counts' dtype."""
    return torch.where((counts < 0) | (counts > _SAT), _SAT, counts)


def seed_score_table(mom: KmerTable, dad: KmerTable, capacity: int) -> ScoreTable:
    """Union of the parental tables as a scoring table: child counts 0, pcounts packed
    (dad's half shifted into the high 16 bits of the 32-bit pack). Both tables are sorted
    and unique, so the union is one merge (``_merge_sorted``) and nothing is sorted."""
    with span("seed", mom.keys.device):
        keys, cols, n = _merge_sorted(mom.keys, mom.n, [None, _sat16(mom.counts)],
                                      dad.keys, dad.n, [None, _sat16(dad.counts) << 16],
                                      capacity)
        return ScoreTable(keys=keys, counts=cols[0], pcounts=cols[1], n=n)


def flush_score(
    acc: KmerAccumulator, tab: ScoreTable, out_capacity: int = 0
) -> Tuple[KmerAccumulator, ScoreTable]:
    """Aggregate the raw-k-mer staging buffer into the scoring table; reset the buffer.

    Identical structure to ``ops.stream.flush`` with the pcounts column riding along
    (staged raw k-mers contribute pcounts 0; seeded rows carry the parental packs).
    ``out_capacity`` (default: same as input) lets a pipeline seed at a tight
    |mom ∪ dad| capacity and grow to the full table capacity on the first flush."""
    C = tab.capacity
    out_c = out_capacity or C
    with span("flush_score", tab.keys.device):
        w_keys, w_counts, w_n = _staged_groups(acc.kmers[:acc.fill], acc.valid[:acc.fill])
        keys, cols, n = _merge_sorted(tab.keys, tab.n, [tab.counts, tab.pcounts],
                                      w_keys, w_n, [w_counts, None], out_c)
        # overflow is sticky across flushes (see table.merge_tables)
        out = ScoreTable(keys=keys, counts=cols[0], pcounts=cols[1],
                         n=_sticky_overflow_n(n, out_c, tab.n > C))
    return acc._replace(fill=0), out


def merge_score_tables(a: ScoreTable, b: ScoreTable, capacity: int) -> ScoreTable:
    """Merge two scoring tables (both weight columns add, wrapped to 32 bits) in one
    ``_merge_sorted``. The parental pack stays exact because each key's seed lives in one
    input only; overflow of either input is sticky (see table.merge_tables)."""
    keys, cols, n = _merge_sorted(a.keys, a.n, [a.counts, a.pcounts],
                                  b.keys, b.n, [b.counts, b.pcounts], capacity)
    return ScoreTable(keys=keys, counts=cols[0], pcounts=cols[1],
                      n=_sticky_overflow_n(n, capacity, a.n > a.capacity, b.n > b.capacity))


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
    with span("call", tab.keys.device):
        counts, pcounts = u32(tab.counts), u32(tab.pcounts)
        momc = pcounts & _SAT
        dadc = pcounts >> 16
        flags = (
            valid_rows(tab.n, tab.capacity)
            & (counts >= min_child_count)
            & (momc <= tau_parent)
            & (dadc <= tau_parent)
        )
        order = torch.argsort((~flags).to(torch.int8), stable=True)
        return Candidates(
            keys=u32(tab.keys[order]),
            child_counts=counts[order],
            mom_counts=momc[order],
            dad_counts=dadc[order],
            n=flags.sum(),
        )
