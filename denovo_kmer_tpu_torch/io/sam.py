"""SAM text reader and writer: a copy of ``denovo_kmer_tpu/io/sam.py``.

Parses headers (@SQ contigs retained) and alignment lines into ``BamRecord``-compatible
records so every downstream consumer (record filter, packers, region overlap math) works
unchanged. Supports plain, gzip, and BGZF-compressed ``.sam`` / ``.sam.gz`` files and URLs
(``io/remote.open_binary``). Only the fields the engine consumes are fully decoded (QNAME,
FLAG, RNAME→refid, POS, MAPQ, CIGAR, SEQ, QUAL); tags are ignored. Evidence output
(``-o reads.sam``) writes through ``format_sam_record`` and ``sam_header_lines``.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Optional, Sequence, Tuple

from denovo_kmer_tpu_torch.io.bam import CIGAR_OPS, BamRecord

_OP2CODE = {c: i for i, c in enumerate(CIGAR_OPS)}


def _open_text(path: str):
    from denovo_kmer_tpu_torch.io.remote import open_binary

    f = open_binary(path)
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":  # gzip/BGZF
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return io.TextIOWrapper(f, encoding="ascii")


def _parse_cigar(s: str) -> Tuple[Tuple[int, int], ...]:
    if s == "*":
        return ()
    out: List[Tuple[int, int]] = []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            try:
                out.append((n, _OP2CODE[ch]))
            except KeyError:
                raise ValueError(f"bad CIGAR op {ch!r} in {s!r}") from None
            n = 0
    if n:
        raise ValueError(f"CIGAR ends mid-number: {s!r}")
    return tuple(out)


class SamReader:
    """Iterate BamRecord-compatible records from a SAM text file/URL."""

    def __init__(self, path: str):
        self._fh = _open_text(path)
        self.header_lines: List[str] = []
        self.references: List[Tuple[str, int]] = []
        self._pending: Optional[str] = None
        for line in self._fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if line.startswith("@"):
                self.header_lines.append(line)
                if line.startswith("@SQ"):
                    name, length = None, None
                    for fld in line.split("\t")[1:]:
                        if fld.startswith("SN:"):
                            name = fld[3:]
                        elif fld.startswith("LN:"):
                            length = int(fld[3:])
                    if name is None or length is None:
                        raise ValueError(f"@SQ line missing SN/LN: {line!r}")
                    self.references.append((name, length))
            else:
                self._pending = line  # first alignment line, already consumed
                break
        self._ref_ids = {name: i for i, (name, _) in enumerate(self.references)}

    def _parse(self, line: str) -> BamRecord:
        cols = line.split("\t")
        if len(cols) < 11:
            raise ValueError(f"SAM record has {len(cols)} fields (< 11): {line[:80]}")
        rname = cols[2]
        if rname != "*" and rname not in self._ref_ids:
            raise ValueError(f"RNAME {rname!r} not declared in @SQ headers")
        seq = "" if cols[9] == "*" else cols[9]
        qual: Optional[Tuple[int, ...]]
        if cols[10] == "*" or not seq:
            qual = None
        else:
            if len(cols[10]) != len(seq):
                raise ValueError("QUAL length != SEQ length")
            qual = tuple(ord(c) - 33 for c in cols[10])
        nref = cols[6]
        return BamRecord(
            name=cols[0],
            flag=int(cols[1]),
            refid=self._ref_ids.get(rname, -1),
            pos=int(cols[3]) - 1,  # SAM is 1-based; BamRecord.pos is 0-based
            mapq=int(cols[4]),
            cigar=_parse_cigar(cols[5]),
            seq=seq,
            qual=qual,
            next_refid=(
                self._ref_ids.get(rname, -1) if nref == "=" else
                self._ref_ids.get(nref, -1)
            ),
            next_pos=int(cols[7]) - 1,
            tlen=int(cols[8]),
        )

    def __iter__(self) -> Iterator[BamRecord]:
        if self._pending is not None:
            line, self._pending = self._pending, None
            yield self._parse(line)
        for line in self._fh:
            line = line.rstrip("\r\n")
            if line:
                yield self._parse(line)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_sam_records(path: str) -> Iterator[BamRecord]:
    with SamReader(path) as r:
        yield from r


def format_sam_record(r: BamRecord, names: Sequence[str]) -> str:
    """One record → one SAM line (shared by write_sam and the view streamer)."""
    cig = "".join(f"{n}{CIGAR_OPS[op]}" for n, op in r.cigar) or "*"
    qual = "*" if r.qual is None else "".join(chr(q + 33) for q in r.qual)
    rname = names[r.refid] if 0 <= r.refid < len(names) else "*"
    nrname = (
        "=" if r.next_refid == r.refid and r.refid >= 0
        else (names[r.next_refid] if 0 <= r.next_refid < len(names) else "*")
    )
    return "\t".join([
        r.name, str(r.flag), rname, str(r.pos + 1), str(r.mapq), cig,
        nrname, str(r.next_pos + 1), str(r.tlen), r.seq or "*", qual,
    ])


def sam_header_lines(references: Sequence[Tuple[str, int]],
                     header_text: str = "@HD\tVN:1.6\tSO:unsorted") -> List[str]:
    return [header_text] + [f"@SQ\tSN:{n}\tLN:{L}" for n, L in references]


def write_sam(
    path: str,
    records: Sequence[BamRecord],
    references: Sequence[Tuple[str, int]] = (),
    header_text: str = "@HD\tVN:1.6\tSO:unsorted",
) -> str:
    """Write SAM text (fixtures/interchange; inverse of SamReader)."""
    names = [n for n, _ in references]
    lines = sam_header_lines(references, header_text)
    for r in records:
        lines.append(format_sam_record(r, names))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
