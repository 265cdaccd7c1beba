"""Candidate-SITE grouping: overlapping candidate k-mers -> per-locus summary rows.

Port of ``denovo_kmer_tpu/sites.py``; the device step is ``pipeline.candidate_read_batches``
(the extraction kernel and the candidate probe), shared with evidence.

BASELINE.json's north star calls the reporter a "candidate-site reporter": a single de
novo SNV produces up to k overlapping candidate k-mers (they tile the mutated base), so
the k-mer-level report over-counts events. This module groups the candidate k-mers into
loci using the evidence reads' alignment positions (host-side — candidates are
dozens-to-thousands, reads supporting them a tiny subset of the run; the heavy
read-subset step reuses the device probe, pipeline.run_evidence's machinery):

1. device pass over the child reads: extract + probe against the candidate table ->
   matched-read subset (build-throughput, one binary-search probe per window);
2. host pass over the matched subset only: exact substring search (forward + revcomp,
   the call's canonical semantics) finds each candidate's offset in each supporting
   read; a mapped read votes genome position = read.pos + offset (CIGAR-naive: good to
   a few bases around indels, which is all a locus summary needs);
3. candidates take their median voted position; candidates whose [pos, pos+k) intervals
   overlap on the same reference are one locus.

Reads with no usable position (unmapped, sequence-only sources) fall back to read-graph
clustering: candidates whose occurrences OVERLAP (offset delta < k) in at least one read
are the same locus (ref "*", positions read-relative); tandem repeats can over-merge
distinct loci here — the mapped-position pass does not share that limit. Both paths emit
the same TSV:

    #ref  start  end  n_kmers  n_reads  max_child_count  kmers

Sorted by (ref, start). Coordinates are 0-based half-open.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig

_RC = str.maketrans("ACGT", "TGCA")


@dataclasses.dataclass
class Site:
    ref: str  # reference name, or "*" for read-relative loci
    start: int  # 0-based inclusive
    end: int  # exclusive
    kmers: List[str]
    n_reads: int
    max_child_count: int


def _read_occurrences(seq: str, lookup: Dict[str, str], k: int,
                      canonical: bool) -> List[Tuple[str, int]]:
    """(candidate, offset) for every window of ``seq`` that matches a candidate
    under the engine's semantics. ``lookup`` maps the MATCH key (the window's
    canonical form under cfg.canonical, else the forward window) to the
    candidate's ORIGINAL TSV string — candidates given in non-canonical
    orientation still match and are reported under their own label. One pass
    over the read's windows with dict lookups — O(len(seq)·k) per read,
    independent of candidate count (the per-candidate ``str.find`` formulation
    was O(reads × candidates) and measured minutes at scale)."""
    L = len(seq)
    if L < k:
        return []
    out = []
    if not canonical:
        for o in range(L - k + 1):
            km = lookup.get(seq[o : o + k])
            if km is not None:
                out.append((km, o))
        return out
    rc = seq.translate(_RC)[::-1]
    for o in range(L - k + 1):
        fwd = seq[o : o + k]
        rev = rc[L - k - o : L - o]
        km = lookup.get(fwd if fwd <= rev else rev)
        if km is not None:
            out.append((km, o))
    return out


def _cluster_positions(
    votes: Dict[str, List[Tuple[str, int]]], k: int,
    counts: Dict[str, int], support: Dict[str, int],
) -> List[Site]:
    """Candidates -> loci by overlapping [pos, pos+k) on the same ref."""
    placed = []
    for kmer, vs in votes.items():
        if not vs:
            continue
        by_ref: Dict[str, List[int]] = {}
        for ref, p in vs:
            by_ref.setdefault(ref, []).append(p)
        # a candidate can legitimately vote on several refs (repeats); place it
        # on its majority ref at the median position there
        ref = max(by_ref, key=lambda r: len(by_ref[r]))
        pos = int(np.median(by_ref[ref]))
        placed.append((ref, pos, kmer))
    placed.sort()
    sites: List[Site] = []
    for ref, pos, kmer in placed:
        if (sites and sites[-1].ref == ref and pos < sites[-1].end):
            s = sites[-1]
            s.end = max(s.end, pos + k)
            s.kmers.append(kmer)
            s.n_reads = max(s.n_reads, support.get(kmer, 0))
            s.max_child_count = max(s.max_child_count, counts.get(kmer, 0))
        else:
            sites.append(Site(ref=ref, start=pos, end=pos + k, kmers=[kmer],
                              n_reads=support.get(kmer, 0),
                              max_child_count=counts.get(kmer, 0)))
    return sites


def _cluster_readgraph(
    co: Dict[int, List[Tuple[str, int]]], k: int,
    counts: Dict[str, int], support: Dict[str, int],
    only: Optional[set] = None,
) -> List[Site]:
    """Positionless fallback: union-find over candidates whose occurrences
    overlap (adjacent offsets with delta < k) in at least one read — usually
    the tiling windows of one event, though repeats whose occurrences happen
    to overlap in a single read can over-merge (deltas are NOT checked for
    consistency across reads; the mapped-position pass is the precise one).
    ``co`` is keyed by a per-read ORDINAL (read names are not unique: paired
    mates share one name). ``only`` restricts to a candidate subset (used for
    candidates left unplaced by the position pass). Spans are synthetic
    non-overlapping ordinals on ref "*" (i·k .. i·k+k) — read-relative offsets
    carry no shared coordinate system."""
    parent: Dict[str, str] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    seen = set()
    for occ in co.values():
        occ = sorted(
            (t for t in occ if only is None or t[0] in only), key=lambda t: t[1]
        )
        for kmer, _ in occ:
            seen.add(kmer)
        for (ka, oa), (kb, ob) in zip(occ, occ[1:]):
            if ob - oa < k:
                union(ka, kb)
    groups: Dict[str, List[str]] = {}
    for kmer in sorted(seen):
        groups.setdefault(find(kmer), []).append(kmer)
    sites = []
    for i, (root, kmers) in enumerate(sorted(groups.items())):
        kmers.sort()
        sites.append(Site(
            ref="*", start=i * k, end=i * k + k, kmers=kmers,
            n_reads=max((support.get(km, 0) for km in kmers), default=0),
            max_child_count=max((counts.get(km, 0) for km in kmers), default=0),
        ))
    return sites


def group_sites(
    child_path: str,
    candidates_tsv: str,
    cfg: EngineConfig,
    region: Optional[str] = None,
    device=None,
) -> List[Site]:
    """Group the TSV's candidate k-mers into loci using child-read evidence.
    ``device=None`` runs the device step on the card."""
    from denovo_kmer_tpu_torch.io.bam import BamRecord
    from denovo_kmer_tpu_torch.pipeline import (
        _engine_view_of_seq,
        candidate_read_batches,
        candidate_table,
        candidate_words_from_tsv,
        parse_candidates_tsv,
        resolve_device,
        source_references,
    )

    parsed = parse_candidates_tsv(candidates_tsv)
    cands: List[str] = [km for km, _c in parsed]
    counts: Dict[str, int] = dict(parsed)
    if not cands:
        return []
    k = len(cands[0])

    dev = resolve_device(device)
    table = candidate_table(candidate_words_from_tsv(candidates_tsv, cfg), dev)
    refs = source_references(child_path)
    ref_names = [n for n, _ in refs]

    # match key (canonical form under cfg.canonical; forward string otherwise)
    # -> the candidate's ORIGINAL TSV label (non-canonical TSVs must still match)
    if cfg.canonical:
        lookup = {}
        for km in cands:
            r = km.translate(_RC)[::-1]
            lookup[km if km <= r else r] = km
    else:
        lookup = {km: km for km in cands}
    votes: Dict[str, List[Tuple[str, int]]] = {km: [] for km in cands}
    support: Dict[str, int] = {km: 0 for km in cands}
    co: Dict[int, List[Tuple[str, int]]] = {}  # read ORDINAL -> occurrences
    any_mapped = False
    ordinal = 0

    for batch, mask in candidate_read_batches(child_path, table, cfg, region):
        for r, m in zip(batch, mask):
            ordinal += 1
            if not m:
                continue
            # scan the sequence AS THE DEVICE SAW IT (max_read_len truncation +
            # min_base_quality masking) so a position vote can never come from a
            # window the calling engine's semantics excluded
            occs = _read_occurrences(
                _engine_view_of_seq(r, cfg).upper(), lookup, k, cfg.canonical
            )
            if not occs:
                continue  # probe hit but engine-view mismatch (quality-masked)
            mapped = (isinstance(r, BamRecord) and not (r.flag & 4)
                      and 0 <= r.refid < len(ref_names) and r.pos >= 0)
            for km in {km for km, _ in occs}:
                support[km] += 1  # per READ, not per occurrence (tandem repeats)
            if mapped:
                any_mapped = True
                for km, off in occs:
                    votes[km].append((ref_names[r.refid], r.pos + off))
            co[ordinal] = occs

    if any_mapped:
        sites = _cluster_positions(votes, k, counts, support)
    else:
        sites = _cluster_readgraph(co, k, counts, support)
    # candidates not placed yet — no position vote (only unmapped support) on
    # the mapped branch, or no occurrence at all on either branch — land on
    # ref "*" via the read graph, then as zero-support singletons: the caller
    # reported every candidate, so the site report accounts for every one
    placed = {km for s in sites for km in s.kmers}
    leftover = {km for km in cands if km not in placed}
    if leftover:
        extra = _cluster_readgraph(co, k, counts, support, only=leftover)
        # zero-support singleton spans continue past EVERY existing '*' span
        base = (max((s.start for s in sites + extra if s.ref == "*"),
                    default=-k) // k) + 1
        still = leftover - {km for s in extra for km in s.kmers}
        for j, km in enumerate(sorted(still)):
            extra.append(Site(ref="*", start=(base + j) * k,
                              end=(base + j) * k + k, kmers=[km],
                              n_reads=0, max_child_count=counts.get(km, 0)))
        sites.extend(extra)
    sites.sort(key=lambda s: (s.ref, s.start))  # the documented output order
    return sites


def write_sites_tsv(sites: List[Site], out_path: str) -> None:
    with open(out_path, "w") as f:
        f.write("#ref\tstart\tend\tn_kmers\tn_reads\tmax_child_count\tkmers\n")
        for s in sites:
            f.write(f"{s.ref}\t{s.start}\t{s.end}\t{len(s.kmers)}\t{s.n_reads}"
                    f"\t{s.max_child_count}\t{','.join(s.kmers)}\n")
