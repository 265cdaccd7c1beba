"""One-sort fused final flush + candidate call.

Port of ``denovo_kmer_tpu/ops/fused.py``. The trio call runs directly on the ONE sorted
(score table ∪ staging) stream: no compaction of the final window into a table.

The JAX package shapes this call by TPU costs: 128-lane two-level scans
(``segmented_suffix_sums``, ``extract_rows_2level``), the v5 parent-bad bit packed into bit
31 of the count word with its ``carry_risk`` rerun through v4, and a retry when candidates
exceed the static capacity K. The port sorts once, takes group heads, computes int64
segment sums of the count and pcounts columns, and selects the flagged heads. That is
exactly the result of ``_fused_flush_call_v4`` (``fused.py:233``) — which v5
(``fused.py:334``) equals whenever its carry risk is 0 — for every input: int64 sums
cannot collide with a packed bit, and torch output sizes are dynamic, so neither the v4
rerun nor the K retry exists here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.score import ScoreTable, check_call_args
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, staged_valid
from denovo_kmer_tpu_torch.ops.table import (
    PAD,
    group_heads,
    lex_argsort,
    sort_keys,
    u32,
    valid_rows,
)

_M32 = 0xFFFFFFFF
_SAT = 0xFFFF


def fused_supported(k: int) -> bool:
    """The one-sort call needs the padding key to be unreachable by real k-mers: with
    ``2k % 32 != 0`` the top key word of a real k-mer has zero high bits."""
    return (2 * k) % 32 != 0


def fused_call_full(
    acc: KmerAccumulator,
    tab: ScoreTable,
    tau_parent: int,
    min_child_count: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Final scored flush + candidate call in one sort. Returns host arrays
    (keys (n, W) uint32, child, momc, dadc (n,) uint32) ascending by key — the same order
    as ``ops.score.call_from_score`` — plus n_unique (distinct real keys in table ∪ staging)
    and n_child_unique (those with child count >= 1). Callers ensure ``fused_supported(k)``.

    ``tab`` is the parent-seeded scoring table (possibly holding child counts from earlier
    compacting flushes); ``acc`` the staging buffer of the final window. There is no table
    capacity to overflow: the groups live in the sorted stream itself.
    """
    check_call_args(tau_parent, min_child_count)
    C, W = tab.keys.shape
    S = acc.slots
    dev = tab.keys.device
    valid = torch.cat([valid_rows(tab.n, C), staged_valid(acc)])
    rows = torch.cat([tab.keys, u32(acc.kmers)])
    words = [torch.where(valid, rows[:, w], PAD) for w in range(W)]
    del rows
    # staged rows weigh 1 and table rows their carried count; the pack rides on table rows
    cnt = torch.where(
        valid, torch.cat([tab.counts, torch.ones((S,), dtype=torch.int64, device=dev)]), 0
    )
    pc = torch.where(
        valid, torch.cat([tab.pcounts, torch.zeros((S,), dtype=torch.int64, device=dev)]), 0
    )

    keys = sort_keys(words)
    perm = lex_argsort(keys)
    head = group_heads([k[perm] for k in keys])
    del keys
    heads = torch.nonzero(head).squeeze(1)  # host sync: the call's one fetch follows
    ends = torch.cat([heads[1:], torch.tensor([head.shape[0]], device=dev)])

    def group_sums(col):
        csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(col[perm], 0)])
        return (csum[ends] - csum[heads]) & _M32

    child = group_sums(cnt)
    pcsum = group_sums(pc)
    momc = pcsum & _SAT
    dadc = pcsum >> 16

    src = perm[heads]  # input row of each group's head
    real = words[0][src] != PAD
    has_child = real & (child >= 1)
    flags = has_child & (child >= min_child_count) & (momc <= tau_parent) & (dadc <= tau_parent)
    sel = src[flags]
    cand_keys = torch.stack([w[sel] for w in words], dim=1)

    def host32(t):
        return t.cpu().numpy().astype(np.uint32)

    return (
        host32(cand_keys),
        host32(child[flags]),
        host32(momc[flags]),
        host32(dadc[flags]),
        int(real.sum()),
        int(has_child.sum()),
    )
