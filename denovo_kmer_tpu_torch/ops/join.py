"""Sorted joins: the trio inner join and the bulk probe for unordered queries.

Port of ``denovo_kmer_tpu/ops/join.py``. Both are sort-merge joins over a tagged
concatenation, with no random-access lookups:

- ``join_tables_on_child``: all three tables share one sort order (strictly increasing unique
  keys), so one sort of the tagged concatenation groups equal keys into runs of at most three
  rows ordered (mom, dad, child), and each child row reads its parents' counts from at most
  the two rows before it (shift-compares).
- ``probe_table_sorted``: arbitrary (duplicated, unordered) queries sort after the table row
  of their key; the last table row is carried down the sorted stream (the JAX associative
  scan, here a running maximum of table-row indices) and the results go back to query order.

The tables hold int32 bits (``ops/table.py``); both joins widen keys and counts to int64
uint32 values (``u32``) and return counts as int64 uint32 values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from denovo_kmer_tpu_torch.ops.table import (
    PAD,
    KmerTable,
    lex_argsort,
    sort_keys,
    u32,
    valid_rows,
)


def _shifted(a: torch.Tensor, by: int, fill) -> torch.Tensor:
    """``a`` moved down by ``by`` rows, the first ``by`` rows set to ``fill``."""
    head = torch.full((by,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([head, a[:-by]])


def join_tables_on_child(
    child: KmerTable, mom: KmerTable, dad: KmerTable
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """For every child-table slot, the mom and dad counts of that key (0 when absent).

    Returns (child_keys (Cc, W), child_counts, mom_counts, dad_counts, child_valid) in the
    child table's order, as int64 uint32 values. One sort by (padding last, key words,
    source tag) and two shift-compares."""
    W = child.keys.shape[1]
    Cc, Cm, Cd = (t.keys.shape[0] for t in (child, mom, dad))
    dev = child.keys.device

    keys = u32(torch.cat([mom.keys, dad.keys, child.keys]))
    counts = u32(torch.cat([mom.counts, dad.counts, child.counts]))
    # the source tag orders ties (mom=0, dad=1, child=2); padding rows sort after every
    # valid row of the same key and never act as join partners
    valid = torch.cat([valid_rows(mom.n, Cm), valid_rows(dad.n, Cd),
                       valid_rows(child.n, Cc)])
    src = torch.cat([torch.zeros((Cm,), dtype=torch.int64, device=dev),
                     torch.ones((Cd,), dtype=torch.int64, device=dev),
                     torch.full((Cc,), 2, dtype=torch.int64, device=dev)])
    # child slot of each row for the scatter back (table rows -> dropped)
    back = torch.cat([torch.full((Cm + Cd,), Cc, dtype=torch.int64, device=dev),
                      torch.arange(Cc, dtype=torch.int64, device=dev)])

    words = [keys[:, w] for w in range(W)]
    perm = lex_argsort([(~valid).to(torch.int64)] + sort_keys(words) + [src])
    s_words = [w[perm] for w in words]
    s_valid, s_src, s_counts, s_back = valid[perm], src[perm], counts[perm], back[perm]

    def key_eq(shift):
        eq = torch.ones_like(s_valid)
        for w in s_words:
            eq &= w == _shifted(w, shift, PAD)
        # shifted-in rows at the start never match (their fill is not valid)
        return eq & _shifted(s_valid, shift, False) & s_valid

    eq1, eq2 = key_eq(1), key_eq(2)
    src1, src2 = _shifted(s_src, 1, 9), _shifted(s_src, 2, 9)
    cnt1, cnt2 = _shifted(s_counts, 1, 0), _shifted(s_counts, 2, 0)

    is_child = s_src == 2
    # a run is (mom, dad, child): mom at distance 1 or 2, dad only ever at distance 1
    momc = torch.where(eq1 & (src1 == 0), cnt1, torch.where(eq2 & (src2 == 0), cnt2, 0))
    dadc = torch.where(eq1 & (src1 == 1), cnt1, 0)
    momc = torch.where(is_child, momc, 0)
    dadc = torch.where(is_child, dadc, 0)

    slot = torch.where(is_child, s_back, Cc)
    out_mom = torch.zeros((Cc + 1,), dtype=torch.int64, device=dev)
    out_dad = torch.zeros((Cc + 1,), dtype=torch.int64, device=dev)
    out_mom[slot] = momc
    out_dad[slot] = dadc
    return (keys[Cm + Cd:], counts[Cm + Cd:], out_mom[:Cc], out_dad[:Cc],
            valid_rows(child.n, Cc))


def probe_table_sorted(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Bulk probe for arbitrary queries (duplicates allowed): counts (...,) of uint32 values.

    Sort by (key words, source), carry the last valid table row down the sorted stream, and
    scatter the results back to query order. Equals ``ops.table.probe_table``."""
    C, W = table.keys.shape
    q = u32(queries.reshape(-1, W))
    N = q.shape[0]
    dev = table.keys.device

    keys = torch.cat([u32(table.keys), q])
    counts = torch.cat([u32(table.counts), torch.zeros((N,), dtype=torch.int64, device=dev)])
    is_tab = torch.cat([valid_rows(table.n, C),
                        torch.zeros((N,), dtype=torch.bool, device=dev)])
    src = torch.cat([torch.zeros((C,), dtype=torch.int64, device=dev),
                     torch.ones((N,), dtype=torch.int64, device=dev)])
    back = torch.cat([torch.full((C,), N, dtype=torch.int64, device=dev),
                      torch.arange(N, dtype=torch.int64, device=dev)])

    words = [keys[:, w] for w in range(W)]
    perm = lex_argsort(sort_keys(words) + [src])
    s_words = [w[perm] for w in words]
    s_src, s_istab, s_counts, s_back = src[perm], is_tab[perm], counts[perm], back[perm]

    # the JAX ``combine`` scan: every row takes the (key, count) of the last table row at
    # or above it; rows with no table row above carry nothing
    iota = torch.arange(C + N, dtype=torch.int64, device=dev)
    last = torch.cummax(torch.where(s_istab, iota, -1), 0).values
    has = last >= 0
    at = last.clamp(min=0)
    eq = has
    for w in s_words:
        eq = eq & (w[at] == w)
    is_query = s_src == 1
    res = torch.where(eq & is_query, s_counts[at], 0)

    out = torch.zeros((N + 1,), dtype=torch.int64, device=dev)
    out[torch.where(is_query, s_back, N)] = res
    return out[:N].reshape(queries.shape[:-1])
