"""BGZF block gzip codec (pure Python, zlib-backed).

A copy of ``denovo_kmer_tpu/io/bgzf.py``. BGZF is the block-compressed gzip variant used by
BAM: a concatenation of gzip members, each carrying a ``BC`` extra subfield with the
compressed block size, enabling random access via virtual file offsets
``(compressed_offset << 16) | within_block_offset``. Whole blocks inflate through the port's
native library (``io/native.deflate_decompress_native``, libdeflate) where it is built, with
zlib as the fallback; ``readline``, the block-offset walk and the ``.gzi`` index serve faidx
over bgzipped FASTA.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, Optional, Tuple

#: fixed 28-byte BGZF EOF marker block (empty payload)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

MAX_BLOCK_UNCOMPRESSED = 65280  # htslib convention: leave headroom under 64 KiB


class BgzfError(ValueError):
    pass


def _read_block(f: BinaryIO) -> Optional[Tuple[bytes, int]]:
    """Read one BGZF block at the current file offset.

    Returns (uncompressed_payload, compressed_block_size) or None at clean EOF.
    """
    hdr = f.read(12)
    if len(hdr) == 0:
        return None
    if len(hdr) < 12:
        raise BgzfError("truncated BGZF header")
    id1, id2, cm, flg, _mtime, _xfl, _os, xlen = struct.unpack("<4BIBBH", hdr)
    if id1 != 0x1F or id2 != 0x8B or cm != 8 or not (flg & 4):
        raise BgzfError("not a BGZF block (bad gzip/FEXTRA header)")
    extra = f.read(xlen)
    if len(extra) < xlen:
        raise BgzfError("truncated BGZF extra field")
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    if bsize is None:
        raise BgzfError("missing BC subfield in BGZF block")
    cdata_len = bsize - 12 - xlen - 8
    if cdata_len < 0:
        raise BgzfError(
            f"corrupt BGZF block: BSIZE {bsize} smaller than its own headers"
        )
    cdata = f.read(cdata_len)
    tail = f.read(8)
    if len(cdata) < cdata_len or len(tail) < 8:
        raise BgzfError("truncated BGZF block body")
    crc, isize = struct.unpack("<II", tail)
    # libdeflate one-shot when the shim is built (~2-3x zlib streaming; ISIZE is
    # known up front, which is exactly its fast path); zlib stays the fallback
    # AND the normative behavior for size-mismatched streams
    data = None
    try:
        from denovo_kmer_tpu_torch.io.native import deflate_decompress_native

        data = deflate_decompress_native(cdata, isize)
    except ImportError:  # pragma: no cover - shim loader missing entirely
        pass
    if data is None:
        data = zlib.decompress(cdata, wbits=-15)
        if len(data) != isize:
            raise BgzfError(f"BGZF ISIZE mismatch: {len(data)} != {isize}")
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        raise BgzfError("BGZF CRC mismatch")
    return data, bsize


class BgzfReader:
    """Streaming BGZF reader with virtual-offset support.

    ``read(n)`` / ``readexactly(n)`` consume the uncompressed stream; ``tell_virtual()`` reports
    the htslib-style virtual offset, which is how multi-host BAM range sharding assigns work
    (SURVEY.md §5.8).
    """

    def __init__(self, f: BinaryIO):
        self._f = f
        self._block = b""
        self._within = 0
        self._block_coffset = 0
        self._eof = False

    def _advance(self) -> bool:
        self._block_coffset = self._f.tell()
        out = _read_block(self._f)
        if out is None:
            self._eof = True
            return False
        self._block, _ = out
        self._within = 0
        return True

    def read(self, n: int) -> bytes:
        parts = []
        need = n
        while need > 0:
            avail = len(self._block) - self._within
            if avail == 0:
                if self._eof or not self._advance():
                    break
                continue
            take = min(avail, need)
            parts.append(self._block[self._within : self._within + take])
            self._within += take
            need -= take
        return b"".join(parts)

    def readline(self) -> bytes:
        """One line (terminator kept; b'' at EOF). With ``tell_virtual()`` taken
        before the call this walks a text BGZF file (VCF) offset-addressably —
        what the tabix writer needs."""
        parts = []
        while True:
            if self._within >= len(self._block):
                if self._eof or not self._advance():
                    return b"".join(parts)
                continue
            i = self._block.find(b"\n", self._within)
            if i < 0:
                parts.append(self._block[self._within :])
                self._within = len(self._block)
                continue
            parts.append(self._block[self._within : i + 1])
            self._within = i + 1
            return b"".join(parts)

    def readexactly(self, n: int) -> bytes:
        b = self.read(n)
        if len(b) != n:
            raise BgzfError(f"unexpected EOF: wanted {n} bytes, got {len(b)}")
        return b

    def tell_virtual(self) -> int:
        return (self._block_coffset << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset, within = voffset >> 16, voffset & 0xFFFF
        self._f.seek(coffset)
        self._eof = False
        if not self._advance():
            # a cursor taken at end-of-stream (tell_virtual after the last block) points
            # at the EOF marker / file end with within == 0 — a valid "at EOF" position
            # (resume checkpoints persist it; the resumed stream just reads nothing)
            if within == 0:
                self._block = b""
                self._within = 0
                return
            raise BgzfError(f"virtual offset {voffset:#x} past EOF")
        if within > len(self._block):
            raise BgzfError(f"virtual offset {voffset:#x} beyond block")
        self._within = within

    def at_eof(self) -> bool:
        if self._within < len(self._block):
            return False
        while not self._eof:
            if not self._advance():
                return True
            if self._block:
                return False
        return True


class BgzfWriter:
    """BGZF writer: buffers uncompressed bytes, emits ≤64 KiB blocks, appends the EOF marker."""

    def __init__(self, f: BinaryIO, level: int = 6):
        self._f = f
        self._buf = bytearray()
        self._level = level
        self._closed = False

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_UNCOMPRESSED:
            self._flush_block(MAX_BLOCK_UNCOMPRESSED)

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = comp.compress(chunk) + comp.flush()
        bsize = len(cdata) + 12 + 6 + 8  # hdr(12) + extra(6) + crc/isize(8)
        if bsize > 0x10000:
            raise BgzfError("BGZF block overflow (incompressible chunk)")
        hdr = struct.pack(
            "<4BIBBHBBHH",
            0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
            0x42, 0x43, 2, bsize - 1,
        )
        tail = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
        self._f.write(hdr + cdata + tail)

    def close(self) -> None:
        if self._closed:
            return
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_BLOCK_UNCOMPRESSED))
        self._f.write(BGZF_EOF)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_block_offsets(f: BinaryIO) -> Iterator[Tuple[int, int]]:
    """Yield (compressed_offset, uncompressed_len) for every block — used to split a BAM into
    byte ranges for multi-host feeding."""
    while True:
        coff = f.tell()
        out = _read_block(f)
        if out is None:
            return
        data, _ = out
        yield coff, len(data)


# ---------------------------------------------------------------------------
# GZI: block-boundary index for uncompressed-offset random access
# (htslib's ``bgzip -r`` sidecar; faidx over .fa.gz reads through this)
# ---------------------------------------------------------------------------

def is_bgzf(path: str) -> bool:
    """True when the file starts with a gzip member carrying the BGZF ``BC``
    extra subfield (plain gzip lacks it and has no random access)."""
    with open(path, "rb") as f:
        head = f.read(18)
    return (len(head) >= 18 and head[:4] == b"\x1f\x8b\x08\x04"
            and head[12:14] == b"BC")


def build_gzi(path: str, gzi_path: Optional[str] = None) -> str:
    """Scan a BGZF file and write ``<path>.gzi``: u64-LE entry count, then one
    (compressed offset, uncompressed offset) u64-LE pair per block boundary
    after the first block — byte-compatible with htslib's bgzip index."""
    gzi_path = gzi_path or path + ".gzi"
    entries = []
    uoff = 0
    with open(path, "rb") as f:
        first = True
        while True:
            coff = f.tell()
            out = _read_block(f)
            if out is None:
                break
            if not first:
                entries.append((coff, uoff))
            first = False
            uoff += len(out[0])
    import os

    tmp = gzi_path + f".tmp.{os.getpid()}"  # atomic publish (concurrent builders)
    with open(tmp, "wb") as g:
        g.write(struct.pack("<Q", len(entries)))
        for c, u in entries:
            g.write(struct.pack("<QQ", c, u))
    os.replace(tmp, gzi_path)
    return gzi_path


class GziIndex:
    """Loaded .gzi: maps an uncompressed offset to the virtual offset of its
    block, so ``BgzfReader.seek_virtual`` can land on it directly."""

    def __init__(self, coffsets, uoffsets):
        # both include the implicit first block at (0, 0), ascending
        self.coffsets = coffsets
        self.uoffsets = uoffsets

    @classmethod
    def load(cls, gzi_path: str) -> "GziIndex":
        from denovo_kmer_tpu_torch.io.remote import open_binary

        with open_binary(gzi_path) as f:
            (n,) = struct.unpack("<Q", f.read(8))
            raw = f.read(16 * n)
        if len(raw) != 16 * n:
            raise BgzfError(f"{gzi_path}: truncated GZI index")
        co, uo = [0], [0]
        for i in range(n):
            c, u = struct.unpack_from("<QQ", raw, 16 * i)
            # the .gzi format carries no checksum; structural validation is the
            # only defense against a corrupted sidecar (offsets must ascend and
            # block payloads cannot exceed the BGZF 64 KiB bound)
            if c <= co[-1] or u < uo[-1] or u - uo[-1] > 0x10000:
                raise BgzfError(f"{gzi_path}: non-monotonic or oversized GZI "
                                f"entry {i}")
            co.append(c)
            uo.append(u)
        return cls(co, uo)

    def seek(self, reader: "BgzfReader", uoffset: int) -> None:
        """Position ``reader`` at uncompressed byte ``uoffset``, cross-checking
        the landed block's inflated length against the index's uoffset delta —
        catches a corrupted entry before it silently returns shifted bytes."""
        import bisect

        i = bisect.bisect_right(self.uoffsets, uoffset) - 1
        reader.seek_virtual(self.virtual_offset(uoffset))
        if i + 1 < len(self.uoffsets):
            expect = self.uoffsets[i + 1] - self.uoffsets[i]
            if len(reader._block) != expect:
                raise BgzfError(
                    f"GZI index inconsistent with file: block {i} inflates to "
                    f"{len(reader._block)} bytes, index says {expect}"
                )

    def virtual_offset(self, uoffset: int) -> int:
        """Virtual offset addressing uncompressed byte ``uoffset``."""
        import bisect

        i = bisect.bisect_right(self.uoffsets, uoffset) - 1
        within = uoffset - self.uoffsets[i]
        if within > 0xFFFF:
            raise BgzfError(
                f"GZI index inconsistent: offset {uoffset} lands {within} bytes "
                f"into block {i} (blocks are <64 KiB)"
            )
        return (self.coffsets[i] << 16) | within
