"""BGZF block gzip codec (pure Python, zlib-backed).

A copy of the reader and writer of ``denovo_kmer_tpu/io/bgzf.py``. BGZF is the
block-compressed gzip variant used by BAM: a concatenation of gzip members, each carrying a
``BC`` extra subfield with the compressed block size, enabling random access via virtual file
offsets ``(compressed_offset << 16) | within_block_offset``. Inflation is zlib only; the JAX
package's optional libdeflate shim is not ported.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Optional, Tuple

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
    data = zlib.decompress(cdata, wbits=-15)
    if len(data) != isize:
        raise BgzfError(f"BGZF ISIZE mismatch: {len(data)} != {isize}")
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        raise BgzfError("BGZF CRC mismatch")
    return data, bsize


class BgzfReader:
    """Streaming BGZF reader with virtual-offset support."""

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
            # a cursor taken at end-of-stream points at the EOF marker / file end with
            # within == 0 — a valid "at EOF" position
            if within == 0:
                self._block = b""
                self._within = 0
                return
            raise BgzfError(f"virtual offset {voffset:#x} past EOF")
        if within > len(self._block):
            raise BgzfError(f"virtual offset {voffset:#x} beyond block")
        self._within = within


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
