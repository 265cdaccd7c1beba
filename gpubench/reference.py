"""The plain reference of a trio call: canonical k-mer counts and the de novo candidates.

Plain PyTorch over the reads as ``reads.chunk_codes`` makes them (uint8 codes, 4 = N),
independent of the program under test: it imports nothing of it. The semantics are
SPEC_SEMANTICS.md §1-§7: a window of k bases counts once per occurrence when it holds no N;
its value is the 2k-bit number of its bases, first base most significant; the canonical
value is the smaller of it and its reverse complement's; a candidate is a child k-mer seen
at least ``min_child_count`` times and at most ``tau_parent`` times in each parent; the
report lists candidates by ascending value.

A value is held as one int64 limb for 2k <= 62 and as two (the first k - 16 bases, then the
last 16) up to k = 47. Counting runs in blocks: each chunk's windows are split by a hash of
their value into ``BUCKETS`` buckets, and each bucket is counted by one sort, so the largest
sort is a bucket's share of a sample.

``fingerprint_bits`` turns the reference into the benchmark's control: k-mers are counted
by a hash of that many bits in place of their value (one 32-bit key word less than the
value needs; 64 bits at k > 32), as a table keyed by fingerprints would count them, and a
group reports the first value in it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

N_CODE = 4
BUCKET_BITS = 4
BUCKETS = 1 << BUCKET_BITS
_MIX = (0x9E3779B97F4A7C15 - (1 << 64), 0xC2B2AE3D27D4EB4F - (1 << 64))  # odd, as int64
_BASES = np.frombuffer(b"ACGT", np.uint8)


def limb_bases(k: int) -> List[Tuple[int, int]]:
    """The window offsets [a, b) each limb holds, most significant first."""
    if 2 * k <= 62:
        return [(0, k)]
    if k > 47:
        raise ValueError(f"the reference holds k <= 47, not {k}")
    return [(0, k - 16), (k - 16, k)]


def control_bits(k: int) -> Optional[int]:
    """The control's fingerprint width at ``k``: one 32-bit key word fewer than the value
    needs (at k > 32, 64 bits); None where the value fits one word."""
    words = -(-2 * k // 32)
    return None if words == 1 else min(32 * (words - 1), 64)


def _values(c: torch.Tensor, k: int) -> List[torch.Tensor]:
    """Forward values of every window of ``c`` ((n, L) int64 codes), as limbs (n, L-k+1)."""
    P = c.shape[1] - k + 1
    limbs = []
    for a, b in limb_bases(k):
        v = torch.zeros((c.shape[0], P), dtype=torch.int64, device=c.device)
        for j in range(a, b):
            torch.add(c[:, j:j + P], v, alpha=4, out=v)
        limbs.append(v)
    return limbs


def _less(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    """a < b, limbs compared most significant first (each limb non-negative)."""
    less = a[-1] < b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        less = (x < y) | ((x == y) & less)
    return less


def window_keys(codes: torch.Tensor, k: int, canonical: bool = True) -> List[torch.Tensor]:
    """The canonical (or forward) value limbs of every window of ``codes`` with no N, as
    1-D tensors in read-major order."""
    is_n = codes == N_CODE
    c = torch.where(is_n, 0, codes.to(torch.int64))
    csum = torch.nn.functional.pad(is_n.to(torch.int32).cumsum(1), (1, 0))
    ok = (csum[:, k:] - csum[:, :-k]) == 0
    fwd = _values(c, k)
    if canonical:
        rc = [v.flip(1) for v in _values((3 - c).flip(1), k)]
        take = _less(rc, fwd)
        fwd = [torch.where(take, r, f) for r, f in zip(rc, fwd)]
        del rc, take
    return [v[ok] for v in fwd]


def _mix(limbs: List[torch.Tensor]) -> torch.Tensor:
    h = limbs[0] * _MIX[0]
    if len(limbs) > 1:
        h = (h ^ (h >> 29)) + limbs[1] * _MIX[1]
    return h * _MIX[0]


def _fingerprint(limbs: List[torch.Tensor], bits: int) -> torch.Tensor:
    h = _mix(limbs)
    if bits >= 64:
        return h
    return (h >> (64 - bits)) & ((1 << bits) - 1)


def lex_order(limbs: List[torch.Tensor]) -> torch.Tensor:
    """The stable permutation that sorts rows by their limbs, most significant first."""
    order = torch.argsort(limbs[-1], stable=True)
    for limb in reversed(limbs[:-1]):
        order = order[torch.argsort(limb[order], stable=True)]
    return order


def _heads(limbs: List[torch.Tensor]) -> torch.Tensor:
    """Rows of sorted limbs that start a group of equal keys."""
    n = limbs[0].shape[0]
    head = torch.ones(n, dtype=torch.bool, device=limbs[0].device)
    if n > 1:
        diff = torch.zeros(n - 1, dtype=torch.bool, device=limbs[0].device)
        for limb in limbs:
            diff |= limb[1:] != limb[:-1]
        head[1:] = diff
    return head


@dataclasses.dataclass
class Counted:
    """A bucket of a sample's table: ``keys`` (the limbs counted by: the value, or the
    fingerprint) sorted, their ``counts``, and the value each group reports."""

    keys: List[torch.Tensor]
    counts: torch.Tensor
    values: List[torch.Tensor]


def _count(keys: List[torch.Tensor], values: Optional[List[torch.Tensor]]) -> Counted:
    """Group equal keys; ``values`` None where the keys are the values."""
    order = lex_order(keys)
    keys = [x[order] for x in keys]
    head = _heads(keys)
    starts = head.nonzero().flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([head.shape[0]])])
    keys = [x[starts] for x in keys]
    values = keys if values is None else [x[order][starts] for x in values]
    return Counted(keys, ends - starts, values)


def count_sample(chunks: Iterable[torch.Tensor], k: int, canonical: bool,
                 max_read_len: int, fingerprint_bits: Optional[int] = None) -> List[Counted]:
    """A sample's k-mer table as ``BUCKETS`` buckets."""
    parts: List[list] = [[] for _ in range(BUCKETS)]
    for codes in chunks:
        values = window_keys(codes[:, :max_read_len], k, canonical)
        keys = ([_fingerprint(values, fingerprint_bits)] if fingerprint_bits else values)
        bucket = ((_mix(keys) >> (64 - BUCKET_BITS)) & (BUCKETS - 1)).to(torch.uint8)
        order = torch.argsort(bucket)
        sizes = torch.bincount(bucket, minlength=BUCKETS).tolist()
        cols = [x[order] for x in keys] + ([x[order] for x in values]
                                           if fingerprint_bits else [])
        del values, keys, bucket, order
        for b, piece in enumerate(zip(*(c.split(sizes) for c in cols))):
            parts[b].append([p.clone() for p in piece])
        del cols
    out = []
    for b in range(BUCKETS):
        cols = [torch.cat(col) for col in zip(*parts[b])] if parts[b] else None
        parts[b] = None
        if cols is None:
            out.append(None)
        elif fingerprint_bits:
            out.append(_count(cols[:1], cols[1:]))
        else:
            out.append(_count(cols, None))
    return out


@dataclasses.dataclass
class TrioAnswer:
    """What a trio call answers at one k: the tables' unique counts and the candidates
    ((value limbs), child, mom, dad) in report order, on the host."""

    k: int
    tables_n: Dict[str, int]
    values: List[np.ndarray]
    child: np.ndarray
    mom: np.ndarray
    dad: np.ndarray

    def rows(self) -> List[Tuple[int, int, int, int]]:
        """The candidates as (k-mer value, child, mom, dad) Python tuples."""
        if len(self.values) == 1:
            vals = self.values[0].tolist()
        else:
            vals = [(int(h) << 32) | int(lo) for h, lo in zip(*self.values)]
        return list(zip(vals, self.child.tolist(), self.mom.tolist(), self.dad.tolist()))

    def report(self) -> str:
        """The TSV of SPEC_SEMANTICS.md §7."""
        n = self.child.shape[0]
        letters = np.empty((n, self.k), np.uint8)
        j = 0
        for limb, (a, b) in zip(self.values, limb_bases(self.k)):
            for i in range(a, b):
                letters[:, j] = _BASES[(limb >> np.int64(2 * (b - 1 - i))) & 3]
                j += 1
        kmers = letters.view(f"S{self.k}").ravel()
        lines = ["#kmer\tchild_count\tmom_count\tdad_count"]
        lines += [f"{s.decode()}\t{c}\t{m}\t{d}" for s, c, m, d in
                  zip(kmers.tolist(), self.child.tolist(), self.mom.tolist(),
                      self.dad.tolist())]
        return "\n".join(lines) + "\n"


def _shifted(x: torch.Tensor, by: int, fill) -> torch.Tensor:
    """x[i - by], ``fill`` where i < by."""
    out = torch.full_like(x, fill)
    if x.shape[0] > by:
        out[by:] = x[:-by]
    return out


def call(tables: Dict[str, List[Counted]], k: int, tau_parent: int,
         min_child_count: int) -> TrioAnswer:
    """The candidates of three bucketed tables (SPEC_SEMANTICS.md §6-§7)."""
    names = ("mom", "dad", "child")
    tables_n = {s: sum(int(c.counts.shape[0]) for c in tables[s] if c is not None)
                for s in names}
    found = []
    for b in range(BUCKETS):
        parts = [tables[s][b] for s in names]
        if parts[2] is None:
            continue
        rows = [(p, tag) for tag, p in enumerate(parts) if p is not None]
        keys = [torch.cat(col) for col in zip(*(p.keys for p, _t in rows))]
        values = [torch.cat(col) for col in zip(*(p.values for p, _t in rows))]
        counts = torch.cat([p.counts for p, _t in rows])
        tags = torch.cat([torch.full_like(p.counts, t) for p, t in rows])
        order = lex_order(keys)  # stable: equal keys keep mom, dad, child order
        keys = [x[order] for x in keys]
        values = [x[order] for x in values]
        counts, tags = counts[order], tags[order]
        same = [torch.ones_like(tags, dtype=torch.bool) for _ in (1, 2)]
        for by, s in zip((1, 2), same):
            for x in keys:
                s &= x == _shifted(x, by, -1)
        prev_tag, prev2_tag = _shifted(tags, 1, -1), _shifted(tags, 2, -1)
        prev_n, prev2_n = _shifted(counts, 1, 0), _shifted(counts, 2, 0)
        dad = torch.where(same[0] & (prev_tag == 1), prev_n, 0)
        mom = (torch.where(same[0] & (prev_tag == 0), prev_n, 0)
               + torch.where(same[1] & (prev2_tag == 0), prev2_n, 0))
        hit = ((tags == 2) & (counts >= min_child_count) & (mom <= tau_parent)
               & (dad <= tau_parent))
        found.append(([x[hit] for x in values], counts[hit], mom[hit], dad[hit]))
    if found:
        values = [torch.cat(col) for col in zip(*(f[0] for f in found))]
        child, mom, dad = (torch.cat([f[i] for f in found]) for i in (1, 2, 3))
        order = lex_order(values)
        values = [x[order] for x in values]
        child, mom, dad = child[order], mom[order], dad[order]
    else:
        values = [torch.zeros(0, dtype=torch.int64) for _ in limb_bases(k)]
        child = mom = dad = torch.zeros(0, dtype=torch.int64)
    return TrioAnswer(k, tables_n, [x.cpu().numpy() for x in values], child.cpu().numpy(),
                      mom.cpu().numpy(), dad.cpu().numpy())


def trio_answer(sample_chunks, k: int, canonical: bool, max_read_len: int,
                tau_parent: int, min_child_count: int,
                fingerprint_bits: Optional[int] = None) -> TrioAnswer:
    """The reference's answer at ``k``; ``sample_chunks(name)`` gives a sample's read
    chunks (code tensors) anew each call."""
    tables = {s: count_sample(sample_chunks(s), k, canonical, max_read_len,
                              fingerprint_bits)
              for s in ("mom", "dad", "child")}
    return call(tables, k, tau_parent, min_child_count)
