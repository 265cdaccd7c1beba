"""CRAI index (CRAM index): build, read, and indexed region queries.

The CRAI format (SAM spec §"CRAM index") is a gzip-compressed text file, one
line per slice, six tab-separated integers:

    ref_id  alignment_start  alignment_span  container_offset  slice_offset  slice_size

- ``container_offset`` is the absolute file offset of the container (its length
  field); ``slice_offset`` is the byte offset of the slice-header block within
  the container BODY (== the container header's landmark for that slice);
  ``slice_size`` runs to the next landmark (or the body end).
- Multi-reference slices (ref_id -2) are indexed as written; a region query
  treats them as always-candidate and relies on the per-record filter (htslib
  splits them into per-ref lines instead — a pure seek-efficiency difference).

Region semantics mirror io/bai.read_bam_records_region exactly: a record
overlaps ``[beg, end)`` iff ``pos < end and pos + ref_span > beg`` with
ref_span derived from the read features (min 1; placed-unmapped records count
at their coordinate with span 1). Indexed and full-scan paths yield identical
records (tested), the index only skips non-overlapping containers.

Reference parity: the upstream's htslib dependency set provides `samtools
index` for CRAM (ci.yml:24-27); this is the engine's equivalent.

The port's copy of ``denovo_kmer_tpu/io/crai.py``; its imports point at the port.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Iterator, List, Optional, Tuple

from denovo_kmer_tpu_torch.io.bai import parse_region
from denovo_kmer_tpu_torch.io.cram import CramRecord, CramReader, read_block


@dataclasses.dataclass(frozen=True)
class CraiEntry:
    ref_id: int
    start: int  # 1-based alignment start of the slice
    span: int
    container_offset: int
    slice_offset: int
    slice_size: int


def build_crai(cram_path: str) -> List[CraiEntry]:
    """Walk a CRAM's containers and produce one index entry per slice.

    Only the slice-HEADER block at each landmark is decompressed — data blocks
    are skipped wholesale, so indexing is I/O-bound, not codec-bound."""
    from denovo_kmer_tpu_torch.io.cram import CT_SLICE_HEADER, _parse_slice_header

    entries: List[CraiEntry] = []
    with open(cram_path, "rb") as f:
        reader = CramReader(f)
        while True:
            c = reader._read_container()
            if c is None or c["eof"]:
                break
            if c["offset"] < 0:
                raise ValueError("cannot index a non-seekable CRAM stream")
            body = c["body"]
            lands = c["landmarks"]
            for i, l in enumerate(lands):
                end = lands[i + 1] if i + 1 < len(lands) else len(body)
                blk, _ = read_block(body, l)
                if blk.content_type != CT_SLICE_HEADER:
                    raise ValueError(
                        f"landmark {l} does not point at a slice header")
                if blk.data is None:
                    raise ValueError(blk.error)
                sh = _parse_slice_header(blk.data)
                entries.append(CraiEntry(
                    ref_id=sh.ref_id, start=sh.start, span=sh.span,
                    container_offset=c["offset"], slice_offset=l,
                    slice_size=end - l,
                ))
    return entries


def write_crai(cram_path: str, crai_path: Optional[str] = None) -> str:
    """Index a CRAM: writes ``<cram>.crai`` (or ``crai_path``) and returns the path."""
    entries = build_crai(cram_path)
    out = crai_path or cram_path + ".crai"
    lines = "".join(
        f"{e.ref_id}\t{e.start}\t{e.span}\t{e.container_offset}\t"
        f"{e.slice_offset}\t{e.slice_size}\n"
        for e in entries
    )
    with gzip.open(out, "wb") as f:
        f.write(lines.encode())
    return out


def read_crai(crai_path: str) -> List[CraiEntry]:
    entries = []
    with gzip.open(crai_path, "rb") as f:
        for ln, line in enumerate(f.read().decode().splitlines(), 1):
            if not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) != 6:
                raise ValueError(f"{crai_path}:{ln}: expected 6 fields, "
                                 f"got {len(parts)}")
            v = [int(x) for x in parts]
            entries.append(CraiEntry(*v))
    return entries


def _candidate_offsets(entries: List[CraiEntry], refid: int, beg: int,
                       end: int) -> List[int]:
    """Container offsets whose slices may overlap the region, in file order.
    Multi-ref (-2) slices are always candidates (per-record filter decides)."""
    offs = []
    seen = set()
    for e in entries:
        # CRAI starts are 1-based; beg/end are 0-based half-open (parse_region)
        # span == 0 is legal (encoders that don't track AP spans, e.g. on
        # unsorted data); such slices can hold anything → keep them candidates
        # so the indexed query matches the full-scan path (which only prunes
        # slices with span > 0) — the per-record filter decides.
        hit = (e.ref_id == -2) or (
            e.ref_id == refid and (
                e.span == 0
                or (e.start - 1 < end and (e.start - 1) + e.span > beg)))
        if hit and e.container_offset not in seen:
            seen.add(e.container_offset)
            offs.append(e.container_offset)
    return offs


def load_index_for(cram_path: str) -> Optional[List[CraiEntry]]:
    p = cram_path + ".crai"
    if os.path.exists(p):
        return read_crai(p)
    return None


def read_cram_records_region(
    cram_path: str,
    region: str,
    reference=None,
    index: Optional[List[CraiEntry]] = None,
) -> Iterator[CramRecord]:
    """Yield records overlapping ``region`` (``chr20`` / ``chr20:1,000-2,000``),
    via the .crai when available (seeks only candidate containers) or a full
    scan otherwise. Identical output either way (tests assert index == scan).
    ``reference`` as in CramReader (required for reference-based slices)."""
    with open(cram_path, "rb") as f:
        reader = CramReader(f, reference=reference)
        refid, beg, end = parse_region(region, reader.references)

        if index is None:
            index = load_index_for(cram_path)

        def container_records(c) -> Iterator[Tuple[CramRecord, int, int, int]]:
            for ch, _plan, sh, core, externals, embedded_ref, cont_ref in (
                    reader._body_slices(c["body"], c["ref_id"])):
                # slice-level skip: single-ref slices outside the region can't
                # contribute (multi-ref -2 and unmapped -1 fall through to the
                # record filter / the refid test)
                if sh.ref_id >= 0 and sh.ref_id != refid:
                    continue
                if (sh.ref_id == refid and sh.span > 0
                        and not (sh.start - 1 < end
                                 and (sh.start - 1) + sh.span > beg)):
                    continue
                yield from reader._decode_slice(
                    ch, sh, core, externals, embedded_ref, cont_ref,
                    with_pos=True)

        def overlaps(rid: int, pos0: int, span: int) -> bool:
            # pos0 is the CRAM AP (1-based); convert to 0-based like BamRecord.pos
            p = pos0 - 1
            return rid == refid and p >= 0 and p < end and p + span > beg

        if index is not None:
            for off in _candidate_offsets(index, refid, beg, end):
                f.seek(off)
                c = reader._read_container()
                if c is None or c["eof"]:
                    continue
                for rec, rid, pos0, span in container_records(c):
                    if overlaps(rid, pos0, span):
                        yield rec
            return
        for body, rid_c in reader._container_bodies():
            for rec, rid, pos0, span in container_records(
                    dict(body=body, ref_id=rid_c)):
                if overlaps(rid, pos0, span):
                    yield rec
