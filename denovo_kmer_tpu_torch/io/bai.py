"""BAI/CSI index support: genomic-region-restricted BAM reading (SURVEY.md config 1).

BASELINE config 1 is a "chr20 subset" trio; htslib tools subset by region via the `.bai`
(SAMv1 §5.2 binning R-tree + 16 kb linear index) or `.csi` (§5.3 generalized bins). This
module reads both, WRITES the BAI (this environment has no samtools — the engine indexes
its own fixtures and outputs; `denovo_kmer_tpu index` exposes it), and iterates the records
overlapping a region through the index's chunk list. Without an index the region path falls
back to a full scan + overlap filter — always correct, just not seek-efficient (and the
basis of the index-vs-scan parity tests).

Region strings follow samtools: ``chr20`` (whole contig) or ``chr20:1,000-2,000``
(1-based, inclusive).

The port's copy of ``denovo_kmer_tpu/io/bai.py``; its imports point at the port.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from denovo_kmer_tpu_torch.io.bam import BamReader, BamRecord

BAI_MAGIC = b"BAI\x01"
CSI_MAGIC = b"CSI\x01"
_PSEUDO_BIN = 37450


def _merge_chunks(chunks):
    """Merge overlapping/adjacent sorted (beg, end) virtual-offset chunks (shared by the
    reader's region resolution and both index writers — one copy of the logic)."""
    merged = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
        else:
            merged.append((cb, ce))
    return merged


def record_ref_span(rec: BamRecord) -> int:
    """Reference bases consumed by the alignment (cigar ops M/D/N/=/X), min 1."""
    span = sum(n for n, op in rec.cigar if op in (0, 2, 3, 7, 8))
    return max(span, 1)


def parse_region(region: str, references: List[Tuple[str, int]]):
    """``chr20`` or ``chr20:1,000-2,000`` → (refid, beg0, end0) half-open 0-based."""
    name, _, rng = region.partition(":")
    names = [r[0] for r in references]
    if name not in names:
        raise ValueError(
            f"region contig {name!r} not in BAM header (has: {', '.join(names[:8])}"
            f"{'...' if len(names) > 8 else ''})"
        )
    refid = names.index(name)
    ref_len = references[refid][1]
    if not rng:
        return refid, 0, ref_len
    b, _, e = rng.replace(",", "").partition("-")
    beg0 = max(int(b) - 1, 0) if b else 0
    end0 = int(e) if e else ref_len
    if end0 <= beg0:
        raise ValueError(f"empty region {region!r}")
    return refid, beg0, end0


# ---------------------------------------------------------------------------
# binning (SAMv1 §5.3 pseudocode)
# ---------------------------------------------------------------------------

def reg2bin(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    end -= 1
    level_shift = min_shift
    for level in range(depth, -1, -1):
        shift = min_shift + 3 * (depth - level)
        if beg >> shift == end >> shift:
            # offset of this level: (8^level - 1) / 7
            return ((1 << 3 * level) - 1) // 7 + (beg >> shift)
    return 0


def reg2bins(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> List[int]:
    """All bins that may contain alignments overlapping [beg, end)."""
    end -= 1
    bins = []
    for level in range(depth + 1):
        off = ((1 << 3 * level) - 1) // 7
        shift = min_shift + 3 * (depth - level)
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


# ---------------------------------------------------------------------------
# index structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefIndex:
    bins: Dict[int, List[Tuple[int, int]]]  # bin -> [(chunk_beg, chunk_end) voffsets]
    linear: List[int]  # 16kb-window smallest voffset (BAI only; empty for CSI)


@dataclasses.dataclass
class BamIndex:
    refs: List[RefIndex]
    min_shift: int = 14
    depth: int = 5

    def region_chunks(self, refid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged, sorted candidate chunk list for a region."""
        if refid < 0 or refid >= len(self.refs):
            return []
        ref = self.refs[refid]
        min_off = 0
        if ref.linear:
            w = beg >> 14
            if w < len(ref.linear):
                min_off = ref.linear[w]
            elif ref.linear:
                min_off = ref.linear[-1]
        chunks = []
        for b in reg2bins(beg, end, self.min_shift, self.depth):
            for cb, ce in ref.bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        return _merge_chunks(chunks)


def read_bai(path: str) -> BamIndex:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"bad BAI magic in {path}")
    pos = 4
    (n_ref,) = struct.unpack_from("<i", data, pos)
    pos += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, pos)
        pos += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, pos)
            pos += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, pos)
                pos += 16
                chunks.append((cb, ce))
            if b != _PSEUDO_BIN:
                bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, pos)
        pos += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", data, pos))
        pos += 8 * n_intv
        refs.append(RefIndex(bins=bins, linear=linear))
    return BamIndex(refs=refs)


def read_csi(path: str) -> BamIndex:
    from denovo_kmer_tpu_torch.io.bgzf import BgzfReader

    with open(path, "rb") as f:
        data = BgzfReader(f).read(1 << 40)
    if data[:4] != CSI_MAGIC:
        raise ValueError(f"bad CSI magic in {path}")
    pos = 4
    min_shift, depth, l_aux = struct.unpack_from("<iii", data, pos)
    pos += 12 + l_aux
    (n_ref,) = struct.unpack_from("<i", data, pos)
    pos += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, pos)
        pos += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, _loffset, n_chunk = struct.unpack_from("<IQi", data, pos)
            pos += 16
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, pos)
                pos += 16
                chunks.append((cb, ce))
            pseudo = ((1 << 3 * (depth + 1)) - 1) // 7 + 1
            if b != pseudo:
                bins[b] = chunks
        refs.append(RefIndex(bins=bins, linear=[]))
    return BamIndex(refs=refs, min_shift=min_shift, depth=depth)


class _IndexStatsAccum:
    """Per-reference mapped/unmapped tallies + file-span voffsets for the SAMv1 §5.2
    pseudo-bin metadata samtools emits (`samtools idxstats` reads it back without
    touching the BAM). Shared by the BAI and CSI writers."""

    def __init__(self, n_ref: int):
        self.mapped = [0] * n_ref
        self.unmapped = [0] * n_ref
        self.span: List[Optional[Tuple[int, int]]] = [None] * n_ref
        self.n_no_coor = 0

    def add(self, rec: BamRecord, v_before: int, v_after: int) -> None:
        if 0 <= rec.refid < len(self.mapped) and rec.pos >= 0:
            r = rec.refid
            if rec.flag & 0x4:
                self.unmapped[r] += 1
            else:
                self.mapped[r] += 1
            s = self.span[r]
            self.span[r] = (
                (v_before, v_after) if s is None else (s[0], v_after)
            )
        else:
            self.n_no_coor += 1

    def has(self, r: int) -> bool:
        return self.span[r] is not None

    def pseudo_bin_bytes(self, r: int, pseudo_id: int, csi: bool = False) -> bytes:
        beg, end = self.span[r]
        if csi:
            head = struct.pack("<IQi", pseudo_id, beg, 2)
        else:
            head = struct.pack("<Ii", pseudo_id, 2)
        return head + struct.pack(
            "<QQQQ", beg, end, self.mapped[r], self.unmapped[r]
        )


def index_stats(path: str):
    """Read per-reference (n_mapped, n_unmapped) + n_no_coor back out of a .bai/.csi
    pseudo-bin (`samtools idxstats` fast path). Returns ``(per_ref, n_no_coor)`` or
    ``None`` when the index carries no metadata bins (e.g. written by a tool that
    skips them — callers fall back to streaming the BAM)."""
    if path.endswith(".csi"):
        from denovo_kmer_tpu_torch.io.bgzf import BgzfReader

        with open(path, "rb") as f:
            data = BgzfReader(f).read(1 << 40)
        if data[:4] != CSI_MAGIC:
            raise ValueError(f"bad CSI magic in {path}")
        pos = 4
        min_shift, depth, l_aux = struct.unpack_from("<iii", data, pos)
        pos += 12 + l_aux
        pseudo = ((1 << 3 * (depth + 1)) - 1) // 7 + 1
        bin_head = "<IQi"  # CSI bins carry an loffset
    else:
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"bad BAI magic in {path}")
        pos = 4
        pseudo = _PSEUDO_BIN
        bin_head = "<Ii"
    head_sz = struct.calcsize(bin_head)
    (n_ref,) = struct.unpack_from("<i", data, pos)
    pos += 4
    per_ref: List[Optional[Tuple[int, int]]] = []
    any_meta = False
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, pos)
        pos += 4
        meta = None
        for _ in range(n_bin):
            parts = struct.unpack_from(bin_head, data, pos)
            b, n_chunk = parts[0], parts[-1]
            pos += head_sz
            if b == pseudo and n_chunk == 2:
                _beg, _end, n_map, n_unmap = struct.unpack_from("<QQQQ", data, pos)
                meta = (int(n_map), int(n_unmap))
                any_meta = True
            pos += 16 * n_chunk
        if not path.endswith(".csi"):
            (n_intv,) = struct.unpack_from("<i", data, pos)
            pos += 4 + 8 * n_intv
        per_ref.append(meta)
    n_no_coor = 0
    if pos + 8 <= len(data):
        (n_no_coor,) = struct.unpack_from("<Q", data, pos)
    if not any_meta:
        return None
    return [m or (0, 0) for m in per_ref], int(n_no_coor)


def write_bai(bam_path: str, bai_path: Optional[str] = None) -> str:
    """Index a coordinate-sorted BAM: one sequential pass collecting per-record
    (bin, voffset span) + the 16 kb linear index. Refuses unsorted input like
    `samtools index` — the linear index's chunk clipping is only sound when file
    order follows coordinate order."""
    bai_path = bai_path or bam_path + ".bai"
    with open(bam_path, "rb") as f:
        reader = BamReader(f)
        too_long = [(n, L) for n, L in reader.references if L > (1 << 29)]
        if too_long:
            # the BAI binning scheme hard-caps contigs at 2^29 bp; out-of-spec bins
            # would silently corrupt htslib interop — samtools errors here too
            raise ValueError(
                f"contig {too_long[0][0]} ({too_long[0][1]} bp) exceeds the BAI "
                f"2^29 limit; write a CSI instead (denovo_kmer_tpu index --csi)"
            )
        n_ref = len(reader.references)
        bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
        linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
        stats = _IndexStatsAccum(n_ref)
        v_before = reader.tell_virtual()
        last = (-1, -1)
        for rec in reader:
            v_after = reader.tell_virtual()
            if 0 <= rec.refid < n_ref and rec.pos >= 0:
                # placed-unmapped mates (flag 0x4 with a coordinate) index at their
                # position, like samtools
                if (rec.refid, rec.pos) < last:
                    raise ValueError(
                        f"cannot index: {bam_path} is not coordinate-sorted "
                        f"(record at ref {rec.refid} pos {rec.pos} after {last})"
                    )
                last = (rec.refid, rec.pos)
                end = rec.pos + record_ref_span(rec)
                b = reg2bin(rec.pos, end)
                bins[rec.refid].setdefault(b, []).append((v_before, v_after))
                for w in range(rec.pos >> 14, ((end - 1) >> 14) + 1):
                    lin = linear[rec.refid]
                    if w not in lin or v_before < lin[w]:
                        lin[w] = v_before
            stats.add(rec, v_before, v_after)
            v_before = v_after
    out = bytearray(BAI_MAGIC)
    out += struct.pack("<i", n_ref)
    for r in range(n_ref):
        # merge adjacent chunks within each bin (records are visited in file order)
        packed_bins = {b: _merge_chunks(chunks) for b, chunks in bins[r].items()}
        n_bin = len(packed_bins) + (1 if stats.has(r) else 0)
        out += struct.pack("<i", n_bin)
        for b in sorted(packed_bins):
            chunks = packed_bins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if stats.has(r):
            out += stats.pseudo_bin_bytes(r, _PSEUDO_BIN)
        n_intv = max(linear[r]) + 1 if linear[r] else 0
        out += struct.pack("<i", n_intv)
        prev = 0
        for w in range(n_intv):
            # spec: windows with no alignment carry the previous window's offset
            if w in linear[r]:
                prev = linear[r][w]
            out += struct.pack("<Q", prev)
    out += struct.pack("<Q", stats.n_no_coor)
    with open(bai_path, "wb") as f:
        f.write(bytes(out))
    return bai_path


def write_csi(
    bam_path: str, csi_path: Optional[str] = None, min_shift: int = 14, depth: int = 5
) -> str:
    """Write a CSI index (SAMv1 §5.3: BGZF-wrapped, per-bin loffset, no linear index)."""
    from denovo_kmer_tpu_torch.io.bgzf import BgzfWriter

    csi_path = csi_path or bam_path + ".csi"
    with open(bam_path, "rb") as f:
        reader = BamReader(f)
        n_ref = len(reader.references)
        bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
        stats = _IndexStatsAccum(n_ref)
        v_before = reader.tell_virtual()
        last = (-1, -1)
        for rec in reader:
            v_after = reader.tell_virtual()
            if 0 <= rec.refid < n_ref and rec.pos >= 0:
                if (rec.refid, rec.pos) < last:
                    raise ValueError(
                        f"cannot index: {bam_path} is not coordinate-sorted"
                    )
                last = (rec.refid, rec.pos)
                end = rec.pos + record_ref_span(rec)
                b = reg2bin(rec.pos, end, min_shift, depth)
                bins[rec.refid].setdefault(b, []).append((v_before, v_after))
            stats.add(rec, v_before, v_after)
            v_before = v_after
    pseudo = ((1 << 3 * (depth + 1)) - 1) // 7 + 1
    out = bytearray(CSI_MAGIC)
    out += struct.pack("<iii", min_shift, depth, 0)
    out += struct.pack("<i", n_ref)
    for r in range(n_ref):
        out += struct.pack("<i", len(bins[r]) + (1 if stats.has(r) else 0))
        for b in sorted(bins[r]):
            chunks = _merge_chunks(bins[r][b])
            loffset = min(cb for cb, _ in chunks)
            out += struct.pack("<IQi", b, loffset, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if stats.has(r):
            out += stats.pseudo_bin_bytes(r, pseudo, csi=True)
    out += struct.pack("<Q", stats.n_no_coor)
    with open(csi_path, "wb") as f:
        w = BgzfWriter(f)
        w.write(bytes(out))
        w.close()
    return csi_path


def load_index_for(bam_path: str) -> Optional[BamIndex]:
    import os

    if bam_path.startswith(("http://", "https://")):
        # remote BAM: try fetching the sibling index (tiny next to the BAM itself);
        # without it a region query silently degrades to streaming the whole file
        import tempfile
        import urllib.error

        from denovo_kmer_tpu_torch.io.remote import open_binary

        for suffix, loader in ((".bai", read_bai), (".csi", read_csi)):
            try:
                with open_binary(bam_path + suffix) as f:
                    data = f.read(-1)
            except (OSError, urllib.error.URLError, ValueError):
                continue
            with tempfile.NamedTemporaryFile(suffix=suffix) as tmp:
                tmp.write(data)
                tmp.flush()
                try:
                    return loader(tmp.name)
                except ValueError:
                    continue
        return None
    for suffix, loader in ((".bai", read_bai), (".csi", read_csi)):
        p = bam_path + suffix
        if os.path.exists(p):
            return loader(p)
    return None


def read_bam_records_region(
    bam_path: str, region: str, index: Optional[BamIndex] = None
) -> Iterator[BamRecord]:
    """Yield records overlapping ``region``, via the index when available (seeks only the
    candidate chunks) or a full scan otherwise. Unmapped/other-contig records never
    qualify. Identical output either way (tests assert index == scan)."""
    from denovo_kmer_tpu_torch.io.remote import open_binary

    with open_binary(bam_path) as f:
        reader = BamReader(f)
        refid, beg, end = parse_region(region, reader.references)

        def overlaps(rec: BamRecord) -> bool:
            # placed-unmapped records (flag 0x4 with a coordinate) count as overlapping
            # at their position, matching samtools view region semantics
            if rec.refid != refid or rec.pos < 0:
                return False
            return rec.pos < end and rec.pos + record_ref_span(rec) > beg

        if index is None:
            index = load_index_for(bam_path)
        if index is None:
            for rec in reader:
                if overlaps(rec):
                    yield rec
            return
        for cb, ce in index.region_chunks(refid, beg, end):
            reader.seek_virtual(cb)
            while reader.tell_virtual() < ce:
                try:
                    rec = next(reader)
                except StopIteration:
                    break
                if overlaps(rec):
                    yield rec
                # no positional early-exit: the engine's fixtures are not necessarily
                # coordinate-sorted, and a chunk may interleave positions


def parse_bed(bed_path: str) -> List[str]:
    """BED3+ → region strings (`chrom:beg1-end`). Track/browser/comment lines
    skip; later columns ignore (BED6/12 inputs work)."""
    regions = []
    with open(bed_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            # UCSC header LINES are 'track ...'/'browser ...' (type + whitespace);
            # a CONTIG merely named 'track_ctg1' is data (samtools agrees)
            first = line.split("\t")[0] if "\t" in line else line.split()[0]
            if first in ("track", "browser"):
                continue
            cols = line.split("\t") if "\t" in line else line.split()
            if len(cols) < 3:
                raise ValueError(f"{bed_path}:{lineno}: BED needs >= 3 columns")
            try:
                beg, end = int(cols[1]), int(cols[2])
            except ValueError:
                raise ValueError(
                    f"{bed_path}:{lineno}: non-integer BED coordinates") from None
            if end <= beg:
                raise ValueError(f"{bed_path}:{lineno}: empty BED interval")
            regions.append(f"{cols[0]}:{beg + 1}-{end}")
    return regions


def read_bam_records_regions(
    bam_path: str, regions: List[str], index: Optional[BamIndex] = None
) -> Iterator[BamRecord]:
    """Multi-region iterator (``samtools view -M -L`` semantics): regions merge
    per contig, fetches run in coordinate order, and each overlapping record
    yields exactly ONCE — a record spanning two target intervals is suppressed
    in the later fetch (disjoint sorted intervals ⇒ the already-seen overlap set
    is always the immediately preceding interval)."""
    from denovo_kmer_tpu_torch.io.remote import open_binary

    with open_binary(bam_path) as f:
        refs = BamReader(f).references
    by_ref: Dict[int, List[Tuple[int, int]]] = {}
    for r in regions:
        refid, beg, end = parse_region(r, refs)
        by_ref.setdefault(refid, []).append((beg, end))
    merged_by_ref: Dict[int, List[Tuple[int, int]]] = {}
    for refid in sorted(by_ref):
        ivs = sorted(by_ref[refid])
        merged = [ivs[0]]
        for b, e in ivs[1:]:
            if b <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((b, e))
        merged_by_ref[refid] = merged

    if index is None:
        index = load_index_for(bam_path)
    if index is None:
        # unindexed: ONE full scan testing every interval (samtools -L does one
        # pass too) — M separate region calls would scan the file M times
        with open_binary(bam_path) as f:
            for rec in BamReader(f):
                if rec.pos < 0:
                    continue
                ivs = merged_by_ref.get(rec.refid)
                if ivs and any(rec.pos < e and
                               rec.pos + record_ref_span(rec) > b
                               for b, e in ivs):
                    yield rec
        return
    for refid, merged in merged_by_ref.items():
        prev_end = None
        name = refs[refid][0]
        for beg, end in merged:
            for rec in read_bam_records_region(
                    bam_path, f"{name}:{beg + 1}-{end}", index=index):
                if prev_end is not None and rec.pos < prev_end:
                    continue  # already yielded by the preceding interval
                yield rec
            prev_end = end
