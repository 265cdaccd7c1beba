"""BAM codec (pure Python) — record-level reader/writer over BGZF.

A copy of ``denovo_kmer_tpu/io/bam.py``'s ``BamRecord``, ``BamReader``, ``BamWriter`` and
``read_bam_records`` (BAM v1, SAMv1 spec §4). The records are the same; the per-base nibble
loops are replaced by table lookups, which decode and encode the same bytes faster.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from denovo_kmer_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

BAM_MAGIC = b"BAM\x01"

#: 4-bit nibble code → base character (SAMv1 §4.2.3)
NIB2BASE = "=ACMGRSVTWYHKDBN"
BASE2NIB = {c: i for i, c in enumerate(NIB2BASE)}
BASE2NIB.update({c.lower(): i for i, c in enumerate(NIB2BASE) if c.isalpha()})
BASE2NIB["n"] = 15

#: packed byte → its two bases (high nibble first)
_PAIR = [(NIB2BASE[b >> 4] + NIB2BASE[b & 0xF]).encode() for b in range(256)]
#: latin-1 byte → nibble code (unknown characters → 15, as ``BASE2NIB.get(ch, 15)``)
_NIB_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in BASE2NIB.items():
    _NIB_LUT[ord(_c)] = _i


@dataclasses.dataclass
class BamRecord:
    name: str
    flag: int
    refid: int = -1
    pos: int = -1  # 0-based
    mapq: int = 255
    cigar: Tuple[Tuple[int, int], ...] = ()  # (oplen, opcode)
    seq: str = ""
    qual: Optional[Tuple[int, ...]] = None  # None = missing ('*')
    next_refid: int = -1
    next_pos: int = -1
    tlen: int = 0


class BamError(ValueError):
    pass


class BamReader:
    """Iterate BamRecords from a BGZF-compressed BAM file."""

    def __init__(self, f: BinaryIO):
        self._bgzf = BgzfReader(f)
        magic = self._bgzf.readexactly(4)
        if magic != BAM_MAGIC:
            raise BamError(f"bad BAM magic {magic!r}")
        (l_text,) = struct.unpack("<i", self._bgzf.readexactly(4))
        self.header_text = self._bgzf.readexactly(l_text).rstrip(b"\x00").decode(
            "utf-8", "replace"
        )
        (n_ref,) = struct.unpack("<i", self._bgzf.readexactly(4))
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.readexactly(4))
            name = self._bgzf.readexactly(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.readexactly(4))
            self.references.append((name, l_ref))

    def tell_virtual(self) -> int:
        return self._bgzf.tell_virtual()

    def seek_virtual(self, voffset: int) -> None:
        self._bgzf.seek_virtual(voffset)

    def __iter__(self) -> Iterator[BamRecord]:
        return self

    def __next__(self) -> BamRecord:
        head = self._bgzf.read(4)
        if len(head) == 0:
            raise StopIteration
        if len(head) < 4:
            raise BamError("truncated record length")
        (block_size,) = struct.unpack("<i", head)
        body = self._bgzf.readexactly(block_size)
        return _parse_record(body)


def _parse_record(body: bytes) -> BamRecord:
    (
        refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
        next_refid, next_pos, tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    name = body[off : off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    for _ in range(n_cigar):
        (u,) = struct.unpack_from("<I", body, off)
        cigar.append((u >> 4, u & 0xF))
        off += 4
    nbytes = (l_seq + 1) // 2
    seq = b"".join(map(_PAIR.__getitem__, body[off : off + nbytes]))[:l_seq].decode()
    off += nbytes
    qual_raw = body[off : off + l_seq]
    off += l_seq
    qual: Optional[Tuple[int, ...]]
    if l_seq and qual_raw == b"\xff" * l_seq:
        qual = None
    else:
        qual = tuple(qual_raw)
    return BamRecord(
        name=name, flag=flag, refid=refid, pos=pos, mapq=mapq,
        cigar=tuple(cigar), seq=seq, qual=qual,
        next_refid=next_refid, next_pos=next_pos, tlen=tlen,
    )


def _reg2bin(beg: int, end: int) -> int:
    """SAMv1 spec bin computation (for the mandatory bin field)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _pack_nibbles(seq: str) -> bytes:
    codes = _NIB_LUT[np.frombuffer(seq.encode("latin-1", "replace"), np.uint8)]
    if len(codes) & 1:
        codes = np.append(codes, np.uint8(0))
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


class BamWriter:
    """Write a BAM file (used to build hermetic test fixtures and the synthetic trio)."""

    def __init__(
        self,
        f: BinaryIO,
        references: Sequence[Tuple[str, int]] = (),
        header_text: str = "@HD\tVN:1.6\tSO:unsorted\n",
        level: int = 6,
    ):
        self._w = BgzfWriter(f, level=level)
        text = header_text.encode()
        out = bytearray()
        out += BAM_MAGIC
        out += struct.pack("<i", len(text))
        out += text
        out += struct.pack("<i", len(references))
        for name, length in references:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(bytes(out))

    def write(self, rec: BamRecord) -> None:
        name_b = rec.name.encode() + b"\x00"
        l_seq = len(rec.seq)
        if rec.qual is None:
            qual_b = bytes([0xFF]) * l_seq
        else:
            if len(rec.qual) != l_seq:
                raise BamError("qual length != seq length")
            qual_b = bytes(rec.qual)
        end = rec.pos + max(sum(n for n, op in rec.cigar if op in (0, 2, 3, 7, 8)), 1)
        body = bytearray()
        body += struct.pack(
            "<iiBBHHHiiii",
            rec.refid, rec.pos, len(name_b), rec.mapq,
            _reg2bin(max(rec.pos, 0), max(end, 1)),
            len(rec.cigar), rec.flag, l_seq,
            rec.next_refid, rec.next_pos, rec.tlen,
        )
        body += name_b
        for n, op in rec.cigar:
            body += struct.pack("<I", (n << 4) | op)
        body += _pack_nibbles(rec.seq)
        body += qual_b
        self._w.write(struct.pack("<i", len(body)) + bytes(body))

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bam_records(path: str) -> Iterator[BamRecord]:
    """Iterate all records of a local BAM file (URLs come with a later slice)."""
    with open(path, "rb") as f:
        reader = BamReader(f)
        yield from reader
