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

The JAX package's public protocol of the call is kept for library callers: the packed
``(K+1, W+3)`` output of ``fused_flush_call`` with ``unpack_fused`` / ``extract_candidates``
and ``CandidateOverflowError``, ``fused_call_candidates``, the capacity K
(``max_candidates``) and the ``variant`` names ``"v4"`` / ``"v5"`` (the same exact call
here), and the scan helpers ``segmented_suffix_sums`` and ``extract_rows_2level``. The
pipelines call ``call_rows`` through ``fused_call_full``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.score import ScoreTable, check_call_args
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, staged_valid
from denovo_kmer_tpu_torch.ops.table import (
    PAD,
    _group_sums,
    _rows_device,
    _rows_shape,
    _sorted_groups,
    _unpack_sort_keys,
    group_heads,  # noqa: F401  (the JAX module's public name)
    u32,
    valid_rows,
)
from denovo_kmer_tpu_torch.ops.trio import Candidates
from denovo_kmer_tpu_torch.utils.metrics import span

_M32 = 0xFFFFFFFF
_SAT = 0xFFFF

DEFAULT_MAX_CANDIDATES = 1 << 14
#: the JAX package's sort formulations of the call; here both name the same exact call
_VARIANTS = ("v4", "v5")
DEFAULT_FUSED_VARIANT = "v5"


def default_max_candidates(k: int, capacity: int = None) -> int:
    """The JAX package's candidate capacity K for k: 2^14, four times that below k = 21
    (shorter k-mers give more candidates), at most ``capacity``. The port's call has no
    capacity; K sizes only the packed output of ``fused_flush_call``."""
    K = DEFAULT_MAX_CANDIDATES if k >= 21 else DEFAULT_MAX_CANDIDATES * 4
    return min(K, capacity) if capacity else K


class FusedCallOut(NamedTuple):
    """Host-side view of the fused call's packed output (see ``unpack_fused``)."""

    n_cand: int  # true candidate count (may exceed K)
    n_unique: int  # distinct real keys in table ∪ staging
    n_child_unique: int  # distinct keys with child count >= 1
    keys: np.ndarray  # (K, W) uint32 — candidates ascending by key; rows >= n_cand pad
    child: np.ndarray  # (K,) uint32
    momc: np.ndarray  # (K,) uint32
    dadc: np.ndarray  # (K,) uint32
    carry_risk: int = 0  # JAX's v5 rerun flag; always 0 here (the sums are exact)


class CandidateOverflowError(RuntimeError):
    """More candidates than the fused call's static output capacity."""


def unpack_fused(packed) -> FusedCallOut:
    """The ``(K+1, W+3)`` packed output (a tensor or an array) on the host. Rows 0..K-1 are
    candidate rows [key words | child | mom | dad]; row K holds the scalars [n_cand,
    n_unique, n_child_unique, carry_risk, 0...]."""
    host = (packed.cpu().numpy() if isinstance(packed, torch.Tensor)
            else np.asarray(packed)).astype(np.uint32)
    K, Wp3 = host.shape[0] - 1, host.shape[1]
    W = Wp3 - 3
    return FusedCallOut(
        n_cand=int(host[K, 0]),
        n_unique=int(host[K, 1]),
        n_child_unique=int(host[K, 2]),
        keys=host[:K, :W],
        child=host[:K, W],
        momc=host[:K, W + 1],
        dadc=host[:K, W + 2],
        carry_risk=int(host[K, 3]) if Wp3 >= 4 else 0,
    )


def extract_candidates(packed) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The packed output sliced to the true count: (keys (n, W), child, mom, dad) uint32,
    ascending by key. Raises CandidateOverflowError if n_cand exceeded the capacity K."""
    host = unpack_fused(packed)
    n = host.n_cand
    K = host.keys.shape[0]
    if n > K:
        raise CandidateOverflowError(
            f"{n} candidates exceed the fused call's static capacity {K}; "
            f"retry with max_candidates >= {n}"
        )
    return host.keys[:n], host.child[:n], host.momc[:n], host.dadc[:n]


def segmented_suffix_sums(head: torch.Tensor, *values: torch.Tensor):
    """Suffix sums of each value column (uint32 values, int32 bits or int64) within
    segments, a segment ending where the next row has ``head`` set: at row i, the sum of
    rows i..end of its segment, wrapped to 32 bits; at a head row, its group's total.
    Prefix differences of an int64 scan (the JAX package scans 128-lane blocks). Returns
    a list of int64 tensors."""
    N = head.shape[0]
    dev = head.device
    # the exclusive end of each row's segment: the next head after it, else N
    nxt = torch.where(head[1:], torch.arange(1, N, device=dev), N)
    end = torch.cat([torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,)),
                     torch.full((min(N, 1),), N, dtype=torch.int64, device=dev)])
    outs = []
    for v in values:
        csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(u32(v), 0)])
        outs.append((csum[end] - csum[:N]) & _M32)
    return outs


def extract_rows_2level(flags: torch.Tensor, n_cand, columns, K: int):
    """The flagged rows of each column gathered, in order, into K rows: row t is the t-th
    flagged row for t < min(n_cand, K) and row N-1 after that (the padding index of the
    JAX package's two-level search). Returns (columns gathered to (K,), the indices)."""
    N = flags.shape[0]
    idx = torch.full((K,), N - 1, dtype=torch.int64, device=flags.device)
    hit = torch.nonzero(flags).squeeze(1)
    m = min(int(n_cand), K, hit.numel())
    idx[:m] = hit[:m]
    return [c[idx] for c in columns], idx


def _variant(variant) -> str:
    """The variant a call names (``DENOVO_FUSED_VARIANT`` and then the default when it
    names none); an unknown name raises KeyError, as the JAX dispatch does."""
    v = variant or os.environ.get("DENOVO_FUSED_VARIANT") or DEFAULT_FUSED_VARIANT
    if v not in _VARIANTS:
        raise KeyError(v)
    return v


def fused_supported(k: int) -> bool:
    """The one-sort call needs the padding key to be unreachable by real k-mers: with
    ``2k % 32 != 0`` the top key word of a real k-mer has zero high bits."""
    return (2 * k) % 32 != 0


def _call_parts(parts, tau_parent: int, min_child_count: int):
    """The trio call on the rows of ``parts`` ((rows, valid, [child-count weights, parental
    packs]) blocks, ``table._aggregate_parts``'s form): one key sort, group starts, and each
    group's sums of both columns, wrapped to 32 bits as JAX's uint32 adds wrap. Returns
    device tensors (candidate keys (n, W), child, momc, dadc (n,)) ascending by key, and the
    counts of distinct real keys and of those with child count >= 1 (0-dim)."""
    N = sum(_rows_shape(rows)[0] for rows, _v, _w in parts)
    W = _rows_shape(parts[0][0])[1]
    if N == 0:
        dev = _rows_device(parts[0][0])
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z.reshape(0, W), z, z, z, zero, zero
    s_keys, perm, starts = _sorted_groups(parts)
    U = starts.shape[0]
    child, _ = _group_sums(parts, 0, perm, starts, U, N)
    pcsum, _ = _group_sums(parts, 1, perm, starts, U, N)
    del perm
    words = _unpack_sort_keys([k[starts] for k in s_keys], W)
    del s_keys, starts
    momc = pcsum & _SAT
    dadc = pcsum >> 16
    real = words[0] != PAD
    has_child = real & (child >= 1)
    flags = has_child & (child >= min_child_count) & (momc <= tau_parent) & (dadc <= tau_parent)
    cand_keys = torch.stack([w[flags] for w in words], dim=1)
    return cand_keys, child[flags], momc[flags], dadc[flags], real.sum(), has_child.sum()


def call_rows(words, cnt: torch.Tensor, pc: torch.Tensor, tau_parent: int,
              min_child_count: int):
    """The trio call on an unsorted stream of rows: key ``words`` (W int64 columns, invalid
    rows already set to the padding key), child-count weights ``cnt`` and parental packs
    ``pc`` (0 on invalid rows). Returns device tensors (candidate keys (n, W), child, momc,
    dadc (n,)) ascending by key, and the counts of distinct real keys and of those with
    child count >= 1 (0-dim); see ``_call_parts``."""
    return _call_parts([(list(words), None, [cnt, pc])], tau_parent, min_child_count)


def _call_stream(acc: KmerAccumulator, tab: ScoreTable, tau_parent: int,
                 min_child_count: int):
    """The trio call on the (score table ∪ staging) stream of the final window: staged rows
    weigh 1 and table rows their carried count; the parental pack rides on table rows."""
    check_call_args(tau_parent, min_child_count)
    return _call_parts([(tab.keys, valid_rows(tab.n, tab.capacity), [tab.counts, tab.pcounts]),
                        (acc.kmers, staged_valid(acc), [1, 0])],
                       tau_parent, min_child_count)


def fused_flush_call(
    acc: KmerAccumulator,
    tab: ScoreTable,
    tau_parent: int,
    min_child_count: int,
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
    variant: str = None,
) -> torch.Tensor:
    """The fused call's packed ``(K+1, W+3)`` output, K = ``max_candidates``, as int64
    uint32 values on the table's device, in the JAX package's layout: rows 0..min(n, K)-1
    are the candidates ascending by key [key words | child | mom | dad], rows after them
    zero (padding: JAX's hold a copy of its sorted stream's last row), and row K the scalars
    [n_cand, n_unique, n_child_unique, carry_risk = 0, 0...]. ``variant`` ``"v4"`` and
    ``"v5"`` (default ``DENOVO_FUSED_VARIANT``, then v5) give the same exact output."""
    _variant(variant)
    K = max_candidates
    W = tab.keys.shape[1]
    cand_keys, child, momc, dadc, n_real, n_child = _call_stream(
        acc, tab, tau_parent, min_child_count)
    n = child.shape[0]
    m = min(n, K)
    packed = torch.zeros((K + 1, W + 3), dtype=torch.int64, device=tab.keys.device)
    packed[:m, :W] = cand_keys[:m]
    packed[:m, W] = child[:m]
    packed[:m, W + 1] = momc[:m]
    packed[:m, W + 2] = dadc[:m]
    packed[K, 0] = n
    packed[K, 1] = n_real
    packed[K, 2] = n_child
    return packed


def fused_call_full(
    acc: KmerAccumulator,
    tab: ScoreTable,
    tau_parent: int,
    min_child_count: int,
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
    variant: str = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Final scored flush + candidate call in one sort. Returns host arrays
    (keys (n, W) uint32, child, momc, dadc (n,) uint32) ascending by key — the same order
    as ``ops.score.call_from_score`` — plus n_unique (distinct real keys in table ∪ staging)
    and n_child_unique (those with child count >= 1). Callers ensure ``fused_supported(k)``.

    ``tab`` is the parent-seeded scoring table (possibly holding child counts from earlier
    compacting flushes); ``acc`` the staging buffer of the final window. There is no table
    capacity to overflow: the groups live in the sorted stream itself. ``max_candidates``
    and ``variant`` are the JAX package's (its capacity retry and its sort formulations):
    the result does not depend on them; an unknown variant raises KeyError.
    """
    _variant(variant)

    def host32(t):
        return t.cpu().numpy().astype(np.uint32)

    with span("call", tab.keys.device):
        cand_keys, child, momc, dadc, n_real, n_child = _call_stream(
            acc, tab, tau_parent, min_child_count)
        return (host32(cand_keys), host32(child), host32(momc), host32(dadc), int(n_real),
                int(n_child))


def candidates_from_host(keys: np.ndarray, child: np.ndarray, momc: np.ndarray,
                         dadc: np.ndarray) -> Candidates:
    """Host candidate arrays (n rows, ascending by key) as CPU ``Candidates``."""
    return Candidates(
        keys=torch.from_numpy(keys.astype(np.int64)),
        child_counts=torch.from_numpy(child.astype(np.int64)),
        mom_counts=torch.from_numpy(momc.astype(np.int64)),
        dad_counts=torch.from_numpy(dadc.astype(np.int64)),
        n=torch.tensor(keys.shape[0], dtype=torch.int64),
    )


def fused_call_candidates(
    acc: KmerAccumulator,
    tab: ScoreTable,
    tau_parent: int,
    min_child_count: int,
    max_candidates: int = DEFAULT_MAX_CANDIDATES,
) -> Candidates:
    """The fused call's candidates as ``Candidates`` of n rows on the host (a thin wrapper
    over ``fused_call_full``; ``max_candidates`` as there)."""
    keys, cc, mc, dc, _nu, _ncu = fused_call_full(acc, tab, tau_parent, min_child_count,
                                                  max_candidates)
    return candidates_from_host(keys, cc, mc, dc)
