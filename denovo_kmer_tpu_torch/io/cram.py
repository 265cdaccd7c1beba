"""CRAM 3.0 reader/writer — native CRAM support for the feeder (SURVEY.md §2.1 C3).

The reference consumes CRAM via vendored HTSlib (inferred from its CI dependency set,
ci.yml:18-27); here the container format is implemented directly: itf8/ltf8 varints,
containers → compression header (preservation map, data-series encodings, tag encodings) →
slices (header + core + external blocks), block codecs raw/gzip/bzip2/lzma (stdlib) and
rANS 4x8 (io/rans.py), record decode over the data series, and sequence reconstruction from
the reference (or embedded-reference blocks) with substitution-matrix decoding.

Scope (documented): reader supports the encodings EXTERNAL, HUFFMAN (single-symbol /
canonical codes in the core block), BETA, BYTE_ARRAY_STOP and BYTE_ARRAY_LEN; read features
X/S/I/D/N/H/P/i/b/q/Q/B; AP-delta coding; per-slice embedded references; detached and
next-fragment mates (mate data is parsed, not joined). The writer emits a deliberately
*different* (all-EXTERNAL, single-slice-per-container) encoding profile so reader bugs
cannot be mirrored by construction; fixtures round-trip mapped (feature-coded) and unmapped
(BA-coded) reads through gzip and rANS blocks.

Only seq/qual/flag surface to the engine (BamRecord-compatible), matching the feeder
contract (SPEC_SEMANTICS §4).

The port's copy of ``denovo_kmer_tpu/io/cram.py``; its imports point at the port.
"""

from __future__ import annotations

import bz2
import dataclasses
import hashlib
import io as _io
import lzma
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from denovo_kmer_tpu_torch.io import rans

CRAM_MAGIC = b"CRAM"

# block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

# block compression methods (CRAM 3.0: 0-4; CRAM 3.1 adds 5-8)
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
M_RANSNX16, M_ARITH, M_FQZCOMP, M_TOK3 = 5, 6, 7, 8


class UnsupportedCodecError(ValueError):
    """A block's codec could not decode it (a foreign fqz/tok3 layout the
    spec-shaped containers can't parse). Raised lazily, when the block's bytes
    are actually consumed — name-only blocks degrade to dropped names instead
    (the engine's feeder contract needs only seq/qual/flag, SURVEY.md §3.3)."""

# encoding codec ids
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = (
    0, 1, 2, 3, 4, 5, 6,
)

_SUB_BASES = "ACGTN"


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([
        0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F,
    ])


def itf8_decode(buf, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        v, pos = b0, pos + 1
    elif b0 < 0xC0:
        v = ((b0 & 0x3F) << 8) | buf[pos + 1]
        pos += 2
    elif b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2]
        pos += 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3]
        pos += 4
    else:
        v = ((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | (buf[pos + 2] << 12) | (
            buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F)
        pos += 5
    if v & 0x80000000:
        v -= 1 << 32  # itf8 is a signed 32-bit value
    return v, pos


def ltf8_encode(v: int) -> bytes:
    v &= (1 << 64) - 1
    for extra in range(8):
        if v < (1 << (7 * (extra + 1))) and extra < 7:
            lead = (0xFF << (8 - extra)) & 0xFF
            out = bytearray()
            for i in range(extra, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            out[0] |= lead
            if extra < 7 and out[0] & (1 << (7 - extra)):
                # value bleeds into the tag bit — promote to one more byte
                continue
            return bytes(out)
    return bytes([0xFF]) + struct.pack(">Q", v)


def ltf8_decode(buf, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    extra = 0
    while extra < 8 and (b0 << extra) & 0x80:
        extra += 1
    if extra == 8:
        v = struct.unpack_from(">Q", buf, pos + 1)[0]
        pos += 9
    else:
        v = b0 & (0xFF >> extra) if extra else b0
        pos += 1
        for _ in range(extra):
            v = (v << 8) | buf[pos]
            pos += 1
    if v & (1 << 63):
        v -= 1 << 64
    return v, pos


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: Optional[bytes]  # uncompressed; None when the codec is unsupported
    error: Optional[str] = None  # set iff data is None


def _compress(data: bytes, method: int, rans_order: int = 0,
              lens: Optional[List[int]] = None) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return _gzip(data)
    if method == M_BZIP2:
        return bz2.compress(data)
    if method == M_LZMA:
        return lzma.compress(data, format=lzma.FORMAT_XZ)
    if method == M_RANS:
        return rans.encode(data, order=rans_order)
    if method == M_RANSNX16:
        from denovo_kmer_tpu_torch.io import rans_nx16

        return rans_nx16.encode(data, order=rans_order, use_pack=True, use_rle=True)
    if method == M_ARITH:
        from denovo_kmer_tpu_torch.io import arith

        return arith.encode(data, order=rans_order, use_pack=True, use_rle=True)
    if method == M_TOK3:
        from denovo_kmer_tpu_torch.io import tok3

        return tok3.encode(data)
    if method == M_FQZCOMP:
        from denovo_kmer_tpu_torch.io import fqz

        return fqz.encode(data, lens=lens)
    raise ValueError(f"unknown compression method {method}")


def _gzip(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def _decompress(data: bytes, method: int, raw_size: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        if raw_size >= 0:
            try:
                from denovo_kmer_tpu_torch.io.native import gzip_decompress_native

                res = gzip_decompress_native(bytes(data), raw_size)
                if res is not None:
                    return res
            except ImportError:  # pragma: no cover - shim loader missing
                pass
        return zlib.decompress(data, wbits=47)
    if method == M_BZIP2:
        return bz2.decompress(data)
    if method == M_LZMA:
        return lzma.decompress(data)
    if method == M_RANS:
        return rans.decode(data)
    if method == M_RANSNX16:
        from denovo_kmer_tpu_torch.io import rans_nx16

        return rans_nx16.decode(data, expected_len=raw_size)
    if method == M_ARITH:
        from denovo_kmer_tpu_torch.io import arith

        return arith.decode(data, expected_len=raw_size)
    if method == M_TOK3:
        from denovo_kmer_tpu_torch.io import tok3

        try:
            return tok3.decode(data, expected_len=raw_size)
        except ValueError as e:
            # foreign tok3 layouts this spec-shaped container can't parse degrade
            # like an unsupported codec: name blocks drop, anything else fails
            # loudly (io/tok3.py docstring)
            raise UnsupportedCodecError(
                f"CRAM 3.1 name tokenizer block did not parse ({e}); "
                f"names are dropped when this block carries the RN series"
            )
    if method == M_FQZCOMP:
        from denovo_kmer_tpu_torch.io import fqz

        try:
            return fqz.decode(data, expected_len=raw_size)
        except ValueError as e:
            # foreign fqz layouts this spec-shaped container can't parse: the
            # lazy block error is LOUD when the block feeds QS (quals drive the
            # base-quality filter) and only degrades for droppable series
            raise UnsupportedCodecError(
                f"CRAM 3.1 fqzcomp block did not parse ({e}); re-encode with "
                f"`samtools view -O cram,version=3.0` or with archive-profile "
                f"codecs disabled"
            )
    raise ValueError(f"unknown compression method {method}")


# fixture hook (tests only): per-series block-method overrides for the writer, e.g.
# {"RN": M_TOK3} to compress a single series with a different codec. Setting
# _OVERRIDES_LABEL_RAW makes overridden blocks carry the RAW series bytes under the
# override's method byte instead of compressing (used to fixture a tok3/fqz block
# whose payload is NOT a valid container, exercising the reader's foreign-layout
# handling: drop-names degradation vs loud quality failure).
_METHOD_OVERRIDES: Dict[str, int] = {}
_OVERRIDES_LABEL_RAW = False


def write_block(out, method: int, ctype: int, cid: int, data: bytes,
                rans_order: int = 0, lens: Optional[List[int]] = None) -> None:
    if _OVERRIDES_LABEL_RAW and method in _METHOD_OVERRIDES.values():
        comp = data  # fixture-only: label raw bytes with the foreign method
    else:
        comp = _compress(data, method, rans_order, lens=lens)
        if len(comp) >= len(data) and method != M_RAW:
            method, comp = M_RAW, data
    body = bytearray()
    body.append(method)
    body.append(ctype)
    body += itf8_encode(cid)
    body += itf8_encode(len(comp))
    body += itf8_encode(len(data))
    body += comp
    body += struct.pack("<I", zlib.crc32(bytes(body)))
    out.write(bytes(body))


def read_block(buf: bytes, pos: int) -> Tuple[Block, int]:
    start = pos
    method = buf[pos]
    ctype = buf[pos + 1]
    pos += 2
    cid, pos = itf8_decode(buf, pos)
    comp_size, pos = itf8_decode(buf, pos)
    raw_size, pos = itf8_decode(buf, pos)
    comp = buf[pos : pos + comp_size]
    pos += comp_size
    crc = struct.unpack_from("<I", buf, pos)[0]
    if zlib.crc32(buf[start:pos]) != crc:
        raise ValueError("CRAM block CRC mismatch")
    pos += 4
    try:
        data = _decompress(comp, method, raw_size)
    except UnsupportedCodecError as e:
        # defer: only raise when the block's bytes are actually consumed, so a
        # name-tokenizer block in a file whose seq/qual/flag decode fine degrades
        # to dropped names instead of rejecting the file
        return Block(method, ctype, cid, None, error=str(e)), pos
    if len(data) != raw_size:
        raise ValueError(f"block raw size mismatch: {len(data)} != {raw_size}")
    return Block(method, ctype, cid, data), pos


# ---------------------------------------------------------------------------
# encodings (readers over core/external streams)
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


def _resolve_itf8_run():
    """Native bulk varint decoder, or None (pure-Python envs). Resolved once."""
    global _ITF8_RUN
    try:
        from denovo_kmer_tpu_torch.io.native import itf8_decode_run_native, native_available

        _ITF8_RUN = itf8_decode_run_native if native_available() else None
    except Exception:
        _ITF8_RUN = None
    return _ITF8_RUN


_ITF8_RUN: object = _resolve_itf8_run  # sentinel: unresolved until first itf8()


class _ByteStream:
    """External block reader. ``itf8`` predecodes a run of varint frames in one
    native call (the record loop reads ~9 small ints per record — BF/CF/RL/AP/
    MQ/TL/... — and the per-call Python varint parse dominated the CRAM feeder
    after byte runs went bulk). The cache is valid only while consumption stays
    on the predecoded frame boundaries: any byte()/take()/until() moves ``pos``
    off the expected frame start, which the next itf8() detects and re-decodes
    from the live position — semantics are bit-identical to the scalar path
    (differential-tested in tests/test_cram_native.py). The predecode size
    adapts: it doubles on cleanly-consumed runs (pure int series) and shrinks
    on mixed access (shared len+val blocks), so worst-case cost stays scalar."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._ivals: List[int] = []
        self._iends: List[int] = []
        self._ii = 0  # next cached frame
        self._in = 0  # cached frame count
        self._iexp = -1  # pos the next cached frame is valid at
        self._ichunk = 512

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("external stream underrun")
        self.pos += n
        return b

    def itf8(self) -> int:
        i = self._ii
        if i < self._in and self.pos == self._iexp:
            v = self._ivals[i]
            p = self._iends[i]
            self._ii = i + 1
            self.pos = p
            self._iexp = p
            return v
        return self._itf8_refill()

    def _itf8_refill(self) -> int:
        run = _ITF8_RUN
        if run is _resolve_itf8_run:
            run = _resolve_itf8_run()
        if self._ii < self._in:
            # mixed access invalidated the cache mid-run: predecoding is mostly
            # wasted here, shrink toward scalar cost
            self._ichunk = max(1, self._ichunk >> 3)
        elif self._in:
            self._ichunk = min(131072, self._ichunk << 1)
        self._ii = self._in = 0
        if run is not None and self._ichunk > 1:
            vals, ends = run(self.data, self.pos, self._ichunk)
            if len(vals):
                self._ivals = vals.tolist()  # Python ints, as the scalar path yields
                self._iends = ends.tolist()
                self._in = len(self._ivals)
                self._iexp = self.pos
                return self.itf8()
        v, self.pos = itf8_decode(self.data, self.pos)
        return v

    def until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.pos)
        b = self.data[self.pos : end]
        self.pos = end + 1
        return b


class _FailedByteStream:
    """External block whose codec is unsupported: raises on ANY byte consumption, so
    series that never touch it (the common name-tokenizer case) cost nothing and
    series that do fail loudly with the codec error."""

    def __init__(self, error: str):
        self.error = error

    def _raise(self):
        raise UnsupportedCodecError(self.error)

    def byte(self):
        self._raise()

    def take(self, n):
        self._raise()

    def itf8(self):
        self._raise()

    def until(self, stop):
        self._raise()


@dataclasses.dataclass
class Encoding:
    codec: int
    params: bytes

    def parse(self):
        """→ (codec, parsed params tuple)."""
        p = self.params
        if self.codec == E_EXTERNAL:
            cid, _ = itf8_decode(p, 0)
            return ("external", cid)
        if self.codec == E_HUFFMAN:
            pos = 0
            n, pos = itf8_decode(p, pos)
            alphabet = []
            for _ in range(n):
                v, pos = itf8_decode(p, pos)
                alphabet.append(v)
            m, pos = itf8_decode(p, pos)
            lens = []
            for _ in range(m):
                v, pos = itf8_decode(p, pos)
                lens.append(v)
            return ("huffman", alphabet, lens)
        if self.codec == E_BETA:
            pos = 0
            offset, pos = itf8_decode(p, pos)
            nbits, pos = itf8_decode(p, pos)
            return ("beta", offset, nbits)
        if self.codec == E_BYTE_ARRAY_STOP:
            stop = p[0]
            cid, _ = itf8_decode(p, 1)
            return ("byte_array_stop", stop, cid)
        if self.codec == E_BYTE_ARRAY_LEN:
            pos = 0
            lcodec, pos = itf8_decode(p, pos)
            llen, pos = itf8_decode(p, pos)
            len_enc = Encoding(lcodec, p[pos : pos + llen])
            pos += llen
            vcodec, pos = itf8_decode(p, pos)
            vlen, pos = itf8_decode(p, pos)
            val_enc = Encoding(vcodec, p[pos : pos + vlen])
            return ("byte_array_len", len_enc, val_enc)
        if self.codec == E_NULL:
            return ("null",)
        raise ValueError(f"unsupported CRAM encoding codec {self.codec}")


class _Decoder:
    """Reads one data series through its encoding from core/external streams."""

    def __init__(self, enc: Encoding, core: _BitReader,
                 externals: Dict[int, _ByteStream]):
        self.kind = enc.parse()
        self.core = core
        self.externals = externals
        if self.kind[0] == "huffman":
            alphabet, lens = self.kind[1], self.kind[2]
            if len(alphabet) == 1 and lens[0] == 0:
                self.const = alphabet[0]
            else:
                # canonical Huffman codes, shortest first, ties by alphabet order
                # canonical code assignment orders by (bit length, SYMBOL VALUE) — the
                # alphabet's serialization order is not significant (CRAM spec §12.4)
                order = sorted(range(len(alphabet)), key=lambda i: (lens[i], alphabet[i]))
                code = 0
                prev_len = lens[order[0]]
                table = {}
                for i in order:
                    code <<= lens[i] - prev_len
                    prev_len = lens[i]
                    table[(lens[i], code)] = alphabet[i]
                    code += 1
                self.table = table
                self.maxlen = max(lens)
        elif self.kind[0] == "byte_array_len":
            self.len_dec = _Decoder(self.kind[1], core, externals)
            self.val_dec = _Decoder(self.kind[2], core, externals)

    def _ext(self, cid) -> _ByteStream:
        try:
            return self.externals[cid]
        except KeyError:
            raise ValueError(f"missing external block {cid}") from None

    def read_int(self) -> int:
        k = self.kind
        if k[0] == "external":
            return self._ext(k[1]).itf8()
        if k[0] == "huffman":
            if hasattr(self, "const"):
                return self.const
            ln = 0
            code = 0
            while ln <= self.maxlen:
                code = (code << 1) | self.core.read_bits(1)
                ln += 1
                if (ln, code) in self.table:
                    return self.table[(ln, code)]
            raise ValueError("bad huffman code")
        if k[0] == "beta":
            return self.core.read_bits(k[2]) - k[1]
        raise ValueError(f"encoding {k[0]} cannot produce ints")

    def read_byte(self) -> int:
        k = self.kind
        if k[0] == "external":
            return self._ext(k[1]).byte()
        return self.read_int()

    def read_bytes(self, n: Optional[int] = None) -> bytes:
        k = self.kind
        if k[0] == "byte_array_stop":
            return self._ext(k[2]).until(k[1])
        if k[0] == "byte_array_len":
            m = self.len_dec.read_int()
            return self.val_dec.read_byte_run(m)
        if k[0] == "external":
            assert n is not None, "external byte array needs an explicit length"
            return self._ext(k[1]).take(n)
        raise ValueError(f"encoding {k[0]} cannot produce byte arrays")

    def read_byte_run(self, n: int) -> bytes:
        """n per-byte reads. EXTERNAL series hold the run contiguously — one
        slice, not n Python-level byte reads (the BA series is per-BASE, so this
        is the CRAM record loop's hottest call)."""
        if self.kind[0] == "external":
            return self._ext(self.kind[1]).take(n)
        return bytes(self.read_byte() for _ in range(n))


# ---------------------------------------------------------------------------
# columnar slice decode (fast path)
# ---------------------------------------------------------------------------
#
# The record loop costs ~9 Python-level series reads per record. But the only
# record fields this reader surfaces are seq/qual/flag/name (SURVEY.md §3.3:
# the engine consumes nothing else), so when every series the OUTPUT needs
# lives in its own external block — the common htslib layout and this module's
# writer profile — a slice can be decoded column-at-a-time instead:
#
# - int series (BF/CF/RL) become ONE native varint-run call per slice
#   (io/_native/cram_util.cpp), not n_records Python calls;
# - BA/QS byte series become slab slices at cumsum(RL) offsets;
# - RN (byte_array_stop) becomes one split on the stop byte;
# - series consumed only for stream sync in the record loop (AP, MQ, RG, the
#   mate fields, TL and every tag) are never touched at all: their blocks are
#   isolated, so skipping them cannot desync anything.
#
# Eligibility is static per compression header (_columnar_plan): a needed
# series must be EXTERNAL with a content id referenced by NO other series
# (sharing would interleave frames), or constant HUFFMAN, or absent where the
# record loop tolerates absence. Mapped records with stored sequences fall
# back to the record loop (reference reconstruction is feature-interleaved).
# The fallback is always the plain record loop — byte-identical output,
# differential-tested across every fixture profile in tests/test_cram.py.


def _sub_table(ch: "CompressionHeader") -> Dict[Tuple[str, int], str]:
    """Substitution matrix (spec §10.6): row per reference base ACGTN; the 2-bit
    field at alt position j holds the BS code assigned to that alternative base,
    so BS code v under reference base rb selects the alt whose field equals v."""
    sm = ch.sub_matrix
    sub: Dict[Tuple[str, int], str] = {}
    for ri, rb in enumerate(_SUB_BASES):
        alts = [b for b in _SUB_BASES if b != rb]
        row = sm[ri]
        for j, alt in enumerate(alts):
            v = (row >> (6 - 2 * j)) & 3
            sub[(rb, v)] = alt
    return sub


def _apply_features(ref: str, ref_off: int, pos0: int, rl: int, feats, sub) -> str:
    """Rebuild one read's bases from the reference and its feature list
    [(code, 1-based read pos, operand)] — the normative reconstruction both the
    record loop and the columnar per-record lane share."""
    out = []
    rp = pos0  # 1-based reference position
    i = 1  # 1-based read position
    fi = 0
    while i <= rl:
        if fi < len(feats) and feats[fi][1] == i:
            code, _, op = feats[fi]
            fi += 1
            if code == "X":  # substitution
                rb = ref[rp - ref_off] if 0 <= rp - ref_off < len(ref) else "N"
                out.append(sub.get((rb.upper(), op), "N"))
                rp += 1
                i += 1
            elif code == "S":  # soft clip
                out.append(op.decode("ascii", "replace"))
                i += len(op)
            elif code == "I":  # insertion
                out.append(op.decode("ascii", "replace"))
                i += len(op)
            elif code == "i":  # single-base insertion
                out.append(chr(op))
                i += 1
            elif code == "b":  # stretch of bases
                out.append(op.decode("ascii", "replace"))
                rp += len(op)
                i += len(op)
            elif code == "D":  # deletion
                rp += op
            elif code == "N":  # ref skip
                rp += op
            elif code in ("H", "P"):  # hard clip / pad: no read bases
                pass
            elif code == "B":  # base + qual
                out.append(chr(op[0]))
                rp += 1
                i += 1
            elif code in ("q", "Q"):  # qual-only features
                pass
            else:
                raise ValueError(f"unsupported read feature {code!r}")
        else:
            idx = rp - ref_off
            out.append(ref[idx] if 0 <= idx < len(ref) else "N")
            rp += 1
            i += 1
    return "".join(out)[:rl]


class _ColumnarIneligible(Exception):
    """Slice outside the columnar fast path — decode via the record loop."""


def _itf8_column(data: bytes, n: int):
    """First ``n`` ITF8 frames of an external block as an int64 array."""
    run = _ITF8_RUN
    if run is _resolve_itf8_run:
        run = _resolve_itf8_run()
    if run is not None:
        vals, _ = run(data, 0, n)
        if len(vals) != n:
            raise ValueError(
                f"external stream underrun: {len(vals)} of {n} varints")
        return vals
    vals = np.empty(n, np.int64)
    pos = 0
    for i in range(n):
        v, pos = itf8_decode(data, pos)
        vals[i] = v
    return vals


def _columnar_plan(ch: "CompressionHeader"):
    """Static fast-path plan for a compression header, or None.

    Returns {series: spec} where spec is ("ext", cid) / ("const", v) /
    ("absent",) / ("stop", stop_byte, cid) / ("bad",) for the output-bearing
    series BF/CF/RL/QS/BA/RN. "bad" defers the decision to slice time: it only
    forces the record-loop fallback if that series is actually consumed.
    """
    kinds: Dict[str, tuple] = {}
    try:
        for key, enc in ch.data_series.items():
            kinds[key] = enc.parse()
        tag_kinds = [enc.parse() for enc in ch.tag_encodings.values()]
    except ValueError:
        return None  # an unparseable encoding hides its block refs — no plan

    # every external content id referenced by ANY series or tag encoding;
    # a needed column requires sole ownership of its block
    refs: Dict[int, int] = {}

    def count(kind):
        if kind[0] == "external":
            refs[kind[1]] = refs.get(kind[1], 0) + 1
        elif kind[0] == "byte_array_stop":
            refs[kind[2]] = refs.get(kind[2], 0) + 1
        elif kind[0] == "byte_array_len":
            count(kind[1].parse() if isinstance(kind[1], Encoding) else kind[1])
            count(kind[2].parse() if isinstance(kind[2], Encoding) else kind[2])

    try:
        for kind in kinds.values():
            count(kind)
        for kind in tag_kinds:
            count(kind)
    except ValueError:
        return None  # unparseable nested encoding — refs unknowable

    def const_of(kind):
        if kind[0] == "huffman" and len(kind[1]) == 1 and kind[2][0] == 0:
            return kind[1][0]
        return None

    def int_spec(key):
        kind = kinds.get(key)
        if kind is None:
            return ("absent",)
        if kind[0] == "external" and refs.get(kind[1]) == 1:
            return ("ext", kind[1])
        c = const_of(kind)
        return ("const", c) if c is not None else ("bad",)

    def bytes_spec(key):
        kind = kinds.get(key)
        if kind is None:
            return ("absent",)
        if kind[0] == "external" and refs.get(kind[1]) == 1:
            return ("ext", kind[1])
        return ("bad",)

    def stop_spec(key):
        kind = kinds.get(key)
        if kind is None:
            return ("absent",)
        if kind[0] == "byte_array_stop" and refs.get(kind[2]) == 1:
            return ("stop", kind[1], kind[2])
        return ("bad",)

    plan = {
        "BF": int_spec("BF"), "CF": int_spec("CF"), "RL": int_spec("RL"),
        "QS": bytes_spec("QS"), "BA": bytes_spec("BA"), "RN": stop_spec("RN"),
        "has_RI": "RI" in kinds,
        # mapped reconstruction columns (consumed only when a slice holds
        # mapped records with stored sequences)
        "AP": int_spec("AP"), "RI": int_spec("RI"), "FN": int_spec("FN"),
        "FP": int_spec("FP"),
        # FC/BS are byte series: "ext" means a raw byte slab, "const" a fill
        "FC": int_spec("FC"), "BS": int_spec("BS"),
        "DL": int_spec("DL"), "RS": int_spec("RS"), "HC": int_spec("HC"),
        "PD": int_spec("PD"),
        "SC": stop_spec("SC"), "IN": stop_spec("IN"), "BB": stop_spec("BB"),
    }
    # BF and RL are unconditionally consumed per record: without clean columns
    # for them the fast path can never run under this header
    if plan["BF"][0] in ("bad", "absent") or plan["RL"][0] in ("bad", "absent"):
        return None
    return plan


# ---------------------------------------------------------------------------
# compression header / slice header
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionHeader:
    preservation: Dict[str, object]
    data_series: Dict[str, Encoding]
    tag_encodings: Dict[int, Encoding]

    @property
    def ap_delta(self) -> bool:
        return bool(self.preservation.get("AP", True))

    @property
    def read_names_included(self) -> bool:
        return bool(self.preservation.get("RN", True))

    @property
    def sub_matrix(self) -> bytes:
        return self.preservation.get("SM", bytes([0x1B] * 5))


def _parse_compression_header(data: bytes) -> CompressionHeader:
    pos = 0
    pres: Dict[str, object] = {}
    _size, pos = itf8_decode(data, pos)
    n, pos = itf8_decode(data, pos)
    for _ in range(n):
        key = data[pos : pos + 2].decode()
        pos += 2
        if key in ("RN", "AP", "RR"):
            pres[key] = bool(data[pos])
            pos += 1
        elif key == "SM":
            pres[key] = data[pos : pos + 5]
            pos += 5
        elif key == "TD":
            ln, pos = itf8_decode(data, pos)
            pres[key] = data[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"unknown preservation key {key}")

    series: Dict[str, Encoding] = {}
    _size, pos = itf8_decode(data, pos)
    n, pos = itf8_decode(data, pos)
    for _ in range(n):
        key = data[pos : pos + 2].decode()
        pos += 2
        codec, pos = itf8_decode(data, pos)
        ln, pos = itf8_decode(data, pos)
        series[key] = Encoding(codec, data[pos : pos + ln])
        pos += ln

    tags: Dict[int, Encoding] = {}
    _size, pos = itf8_decode(data, pos)
    n, pos = itf8_decode(data, pos)
    for _ in range(n):
        key, pos = itf8_decode(data, pos)
        codec, pos = itf8_decode(data, pos)
        ln, pos = itf8_decode(data, pos)
        tags[key] = Encoding(codec, data[pos : pos + ln])
        pos += ln
    return CompressionHeader(pres, series, tags)


@dataclasses.dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    block_ids: List[int]
    embedded_ref_id: int
    md5: bytes = b"\x00" * 16


_ZERO_MD5 = b"\x00" * 16


def _parse_slice_header(data: bytes) -> SliceHeader:
    pos = 0
    ref_id, pos = itf8_decode(data, pos)
    start, pos = itf8_decode(data, pos)
    span, pos = itf8_decode(data, pos)
    n_records, pos = itf8_decode(data, pos)
    record_counter, pos = ltf8_decode(data, pos)
    n_blocks, pos = itf8_decode(data, pos)
    n_ids, pos = itf8_decode(data, pos)
    ids = []
    for _ in range(n_ids):
        v, pos = itf8_decode(data, pos)
        ids.append(v)
    emb, pos = itf8_decode(data, pos)
    # 16-byte reference MD5 follows (spec §8.5); optional tags after — not needed.
    # A truncated header (pre-3.0 style) degrades to the all-zero "unset" value.
    md5 = data[pos : pos + 16]
    if len(md5) < 16:
        md5 = _ZERO_MD5
    return SliceHeader(ref_id, start, span, n_records, record_counter,
                       n_blocks, ids, emb, md5)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CramRecord:
    seq: str
    qual: Optional[Sequence[int]]
    flag: int
    name: Optional[str] = None


BAM_FUNMAP = 0x4


class CramReader:
    """Iterate CRAM records (seq/qual/flag). ``reference`` maps @SQ sequence NAME →
    sequence string (build with ``load_reference``; integer-keyed dicts are accepted and
    matched by @SQ ordinal); required for reference-based slices without an embedded
    reference."""

    def __init__(self, f, reference: Optional[Dict[object, str]] = None,
                 columnar: bool = True, check_md5: bool = True):
        self._f = f
        self.reference = reference or {}
        # verify each reference-based slice's header MD5 against the supplied
        # reference span (htslib validates the same field); skipped for all-zero
        # MD5s, embedded-reference slices, and when no reference was supplied
        self.check_md5 = check_md5
        # columnar=False forces the record loop everywhere — the differential
        # oracle for the fast path (tests/test_cram.py columnar parity suite)
        self.columnar = columnar
        magic = f.read(4)
        if magic != CRAM_MAGIC:
            raise ValueError("not a CRAM file")
        ver = f.read(2)
        self.version = (ver[0], ver[1])
        if ver[0] != 3 or ver[1] not in (0, 1):
            raise ValueError(
                f"CRAM {ver[0]}.{ver[1]} is not supported (this reader implements "
                f"CRAM 3.0 and 3.1)"
            )
        # 3.1 containers decode through the same structure; the added block codecs
        # (rANS Nx16, arith, fqzcomp, tok3) are dispatched per method byte in
        # _decompress; foreign fqz/tok3 layouts raise lazily — loud for quality
        # blocks, dropped names for name blocks (the engine consumes only
        # seq/qual/flag, SURVEY.md §3.3)
        f.read(20)  # file id
        self.sam_header = self._read_file_header()
        # ref id → name from the @SQ lines, in order (the CRAM's authoritative mapping);
        # (name, length) pairs feed io/bai.parse_region for CRAM region queries
        self._sq_names: List[str] = []
        self.references: List[Tuple[str, int]] = []
        for line in self.sam_header.splitlines():
            if line.startswith("@SQ"):
                name, ln = None, 0
                for field in line.split("\t"):
                    if field.startswith("SN:"):
                        name = field[3:]
                    elif field.startswith("LN:"):
                        try:
                            ln = int(field[3:])
                        except ValueError:
                            ln = 0
                if name is not None:
                    self._sq_names.append(name)
                    self.references.append((name, ln))

    def _ref_seq_raw(self, ref_id: int) -> Optional[str]:
        """Resolve a reference id to its sequence by @SQ NAME first, ordinal second."""
        if 0 <= ref_id < len(self._sq_names):
            seq = self.reference.get(self._sq_names[ref_id])
            if seq is not None:
                return seq
        return self.reference.get(ref_id)

    def _ref_seq(self, ref_id: int) -> Optional[str]:
        """Uppercase-normalized reference sequence (htslib uppercases loaded
        references, so soft-masked FASTA decodes identically to its uppercase
        form). Normalization is cached per ref id; GIL-atomic dict ops only,
        same discipline as _ref_bytes (worker threads call this)."""
        raw = self._ref_seq_raw(ref_id)
        if raw is None:
            return None
        cache = self.__dict__.setdefault("_ref_norm", {})
        hit = cache.get(ref_id)
        if hit is not None and hit[0] == len(raw):
            return hit[1]
        norm = raw if raw.isupper() else raw.upper()
        if len(cache) >= 4:
            cache.clear()  # single GIL-atomic op (worker threads race benignly)
        cache[ref_id] = (len(raw), norm)
        return norm

    # --- container plumbing (varints parsed straight off the stream, no over-read) ---

    def _stream_itf8(self) -> int:
        b0 = self._f.read(1)[0]
        extra = 0 if b0 < 0x80 else 1 if b0 < 0xC0 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
        buf = bytes([b0]) + (self._f.read(extra) if extra else b"")
        v, _ = itf8_decode(buf, 0)
        return v

    def _stream_ltf8(self) -> int:
        b0 = self._f.read(1)[0]
        extra = 0
        while extra < 8 and (b0 << extra) & 0x80:
            extra += 1
        buf = bytes([b0]) + (self._f.read(extra) if extra else b"")
        v, _ = ltf8_decode(buf, 0)
        return v

    def _read_container(self):
        try:
            offset = self._f.tell()  # absolute offset of the container (CRAI unit)
        except (OSError, AttributeError):
            offset = -1  # non-seekable stream: indexing impossible, decoding fine
        head = self._f.read(4)
        if len(head) < 4:
            return None
        length = struct.unpack("<i", head)[0]
        ref_id = self._stream_itf8()
        start = self._stream_itf8()
        span = self._stream_itf8()
        n_rec = self._stream_itf8()
        self._stream_ltf8()  # record counter
        self._stream_ltf8()  # bases
        n_blocks = self._stream_itf8()
        n_land = self._stream_itf8()
        landmarks = [self._stream_itf8() for _ in range(n_land)]
        self._f.read(4)  # header CRC32
        body = self._f.read(length)
        if len(body) != length:
            raise ValueError("truncated CRAM container body")
        return dict(ref_id=ref_id, start=start, span=span, n_rec=n_rec,
                    n_blocks=n_blocks, body=body, offset=offset,
                    landmarks=landmarks,
                    eof=(ref_id == -1 and n_rec == 0 and n_blocks == 1
                         and length < 40))

    def _read_file_header(self) -> str:
        c = self._read_container()
        if c is None:
            raise ValueError("truncated CRAM: no header container")
        blk, _ = read_block(c["body"], 0)
        if blk.content_type != CT_FILE_HEADER:
            raise ValueError("first CRAM container is not the SAM header")
        ln = struct.unpack_from("<i", blk.data, 0)[0]
        return blk.data[4 : 4 + ln].decode()

    def __iter__(self) -> Iterator[CramRecord]:
        for ch, plan, sh, core, externals, embedded_ref, cont_ref in self._slices():
            if plan is not None:
                try:
                    # list, not generator: eligibility must settle before the
                    # first yield so the fallback never re-emits records
                    yield from self._decode_slice_columnar(
                        ch, sh, externals, plan, embedded_ref)
                    continue
                except _ColumnarIneligible:
                    pass
            yield from self._decode_slice(ch, sh, core, externals, embedded_ref,
                                          cont_ref)

    def iter_seq_chunks(self, flag_mask: int = 0,
                        max_read_len: int = 1 << 30,
                        with_quals: bool = True,
                        workers: Optional[int] = None) -> Iterator["object"]:
        """Yield one ops.pack.SeqChunk per slice — the packed-feeder handoff
        (pipeline.packed_batches → ops.pack.pack_chunks): flag-filtered,
        length-truncated flat sequence/quality byte columns with NO per-record
        Python on columnar-eligible slices. The RN (name) series is never
        touched on this path — the engine consumes only seq/qual/flag
        (SURVEY.md §3.3). Ineligible slices fall back to the record loop and
        are wrapped into the same chunk form; bit-parity with
        pack_records(CramReader(...)) is the differential contract
        (tests/test_cram_packed.py).

        ``workers`` (default: DENOVO_KMER_INGEST_THREADS capped at the visible
        core count — pooling on a 1-core host measured ~30% pure overhead;
        0/1 = synchronous) decodes CONTAINERS in a thread pool, in order:
        containers are self-contained (own compression header + blocks) and the
        hot work is inside ctypes entropy calls that release the GIL, so this
        scales with cores like the BAM feeder's inflate ring. Byte-identical to
        the serial walk (tests/test_cram_packed.py pool parity)."""
        if workers is None:
            cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
                else (os.cpu_count() or 1)
            try:
                env_workers = int(os.environ.get("DENOVO_KMER_INGEST_THREADS", "4"))
            except ValueError:
                env_workers = 4  # lenient like the C++ feeder's getenv parse
            workers = min(env_workers, cores)
        if workers and workers > 1:
            import collections
            from concurrent.futures import ThreadPoolExecutor

            args = (flag_mask, max_read_len, with_quals)
            with ThreadPoolExecutor(max_workers=workers) as ex:
                pending = collections.deque()
                for body, rid in self._container_bodies():
                    pending.append(
                        ex.submit(self._container_seq_chunks, body, rid, *args))
                    while len(pending) > workers + 2:
                        yield from pending.popleft().result()
                while pending:
                    yield from pending.popleft().result()
            return
        for body, rid in self._container_bodies():
            yield from self._container_seq_chunks(body, rid, flag_mask,
                                                  max_read_len, with_quals)

    def _container_seq_chunks(self, body, ref_id, flag_mask, max_read_len,
                              with_quals) -> List["object"]:
        """One container body → its SeqChunks (a list, so the pool can run whole
        containers on worker threads). Touches no reader state beyond read-only
        config and the GIL-atomic reference cache."""
        out = []
        for ch, plan, sh, core, externals, embedded_ref, cont_ref in (
                self._body_slices(body, ref_id)):
            if plan is not None:
                try:
                    C = self._slice_columns(ch, sh, externals, plan,
                                            embedded_ref, want_names=False)
                    if C is not None:
                        out.append(_chunk_from_columns(C, flag_mask,
                                                       max_read_len, with_quals))
                    continue
                except _ColumnarIneligible:
                    pass
            out.append(_chunk_from_records(
                self._decode_slice(ch, sh, core, externals, embedded_ref,
                                   cont_ref),
                flag_mask, max_read_len, with_quals))
        return out

    # --- record decode ---

    def _slices(self):
        """Walk every slice of every data container: yields (compression
        header, columnar plan, slice header, core bit stream, external block
        map, embedded reference bytes, container ref id) — shared by the
        record iterator and the packed-chunk iterator."""
        for body, rid in self._container_bodies():
            yield from self._body_slices(body, rid)

    def _container_bodies(self):
        """Raw (container body bytes, ref id) stream — the ONLY stage that
        advances the file handle; everything per-body is stateless, which is
        what lets iter_seq_chunks decode containers on worker threads."""
        while True:
            c = self._read_container()
            if c is None or c["eof"]:
                return
            yield c["body"], c["ref_id"]

    def _body_slices(self, body, container_ref_id):
        """Slices of ONE container body (block parse + decompress happen here,
        i.e. on the pool's worker threads under iter_seq_chunks)."""
        pos = 0
        blk, pos = read_block(body, pos)
        if blk.content_type != CT_COMPRESSION_HEADER:
            raise ValueError("expected compression header block")
        if blk.data is None:
            raise UnsupportedCodecError(blk.error)
        ch = _parse_compression_header(blk.data)
        plan = _columnar_plan(ch) if self.columnar else None
        while pos < len(body):
            sblk, pos = read_block(body, pos)
            if sblk.content_type != CT_SLICE_HEADER:
                raise ValueError("expected slice header block")
            if sblk.data is None:
                raise UnsupportedCodecError(sblk.error)
            sh = _parse_slice_header(sblk.data)
            core = None
            externals: Dict[int, _ByteStream] = {}
            embedded_ref = None
            for _ in range(sh.n_blocks):
                b, pos = read_block(body, pos)
                if b.content_type == CT_CORE:
                    if b.data is None:
                        raise UnsupportedCodecError(b.error)
                    core = _BitReader(b.data)
                elif b.content_type == CT_EXTERNAL:
                    if b.data is None:
                        # lazily-failing stream: raises only if a data series
                        # actually pulls bytes from this block
                        externals[b.content_id] = _FailedByteStream(b.error)
                    else:
                        externals[b.content_id] = _ByteStream(b.data)
                    if b.content_id == sh.embedded_ref_id:
                        if b.data is None:
                            raise UnsupportedCodecError(b.error)
                        embedded_ref = b.data
            if (self.check_md5 and sh.md5 != _ZERO_MD5 and sh.ref_id >= 0
                    and sh.start >= 1 and sh.span > 0 and embedded_ref is None):
                self._verify_slice_md5(sh)
            yield ch, plan, sh, core, externals, embedded_ref, container_ref_id

    def _verify_slice_md5(self, sh: SliceHeader) -> None:
        """Slice-header reference MD5 vs the span of the supplied reference the
        slice covers (spec §8.5; htslib errors on mismatch). Tries the span as
        given and uppercased — writers differ on soft-mask normalization."""
        ref = self._ref_seq(sh.ref_id)  # uppercase-normalized, what decode uses
        if ref is None:
            return  # no reference supplied; decode fails later if one is needed
        span = ref[sh.start - 1 : sh.start - 1 + sh.span]
        raw = span.encode("ascii", "replace")
        if hashlib.md5(raw).digest() == sh.md5:
            return
        # writers that hashed the soft-masked bytes as-is (htslib normalizes,
        # but be lenient): retry on the unnormalized span
        rawref = self._ref_seq_raw(sh.ref_id)
        raw2 = (rawref[sh.start - 1 : sh.start - 1 + sh.span]
                .encode("ascii", "replace"))
        if raw2 != raw and hashlib.md5(raw2).digest() == sh.md5:
            return
        name = (self._sq_names[sh.ref_id]
                if 0 <= sh.ref_id < len(self._sq_names) else str(sh.ref_id))
        raise ValueError(
            f"CRAM slice reference MD5 mismatch on {name}:{sh.start}-"
            f"{sh.start + sh.span - 1}: header {sh.md5.hex()} != reference span "
            f"{hashlib.md5(raw).hexdigest()} — wrong or modified reference FASTA "
            f"(pass check_md5=False to override)"
        )

    def _slice_columns(self, ch, sh, externals, plan, embedded_ref=None,
                       want_names=True):
        """Column-at-a-time decode of one slice into flat columns (see the
        fast-path comment at _columnar_plan). Stateless over the block
        buffers: nothing advances a stream cursor, so raising
        _ColumnarIneligible at ANY point leaves the slice pristine for the
        record-loop fallback. Returns None for an empty slice.

        Mapped records with stored sequences reconstruct in two lanes:
        a vectorized lane for records whose features are all X substitutions
        (one reference gather + one LUT scatter per slice — the dominant
        short-read archive shape), and a per-record lane running the shared
        _apply_features for anything else (clips, indels, base stretches,
        multi-ref slices). Feature codes B/Q/q force the record-loop fallback:
        they consume QS bytes interleaved with the per-record quality runs.

        ``want_names=False`` (the packed-chunk path) never touches the RN
        series — the engine consumes only seq/qual/flag (SURVEY.md §3.3)."""
        n = sh.n_records
        if n <= 0:
            return None
        needed_cids = set()

        def ext_data(cid) -> bytes:
            b = externals.get(cid)
            if b is None:
                raise ValueError(f"missing external block {cid}")
            if isinstance(b, _FailedByteStream):
                raise UnsupportedCodecError(b.error)
            return b.data

        def int_col(key, count, default=None):
            spec = plan[key]
            if count == 0:
                return np.zeros(0, np.int64)
            if spec[0] == "ext":
                needed_cids.add(spec[1])
                return _itf8_column(ext_data(spec[1]), count)
            if spec[0] == "const":
                return np.full(count, spec[1], np.int64)
            if spec[0] == "absent" and default is not None:
                return np.full(count, default, np.int64)
            raise _ColumnarIneligible

        def byte_col(key, count):
            spec = plan[key]
            if count == 0:
                return np.zeros(0, np.int64)
            if spec[0] == "ext":
                needed_cids.add(spec[1])
                slab = ext_data(spec[1])
                if len(slab) < count:
                    raise ValueError("external stream underrun")
                return np.frombuffer(slab, np.uint8, count).astype(np.int64)
            if spec[0] == "const":
                return np.full(count, spec[1], np.int64)
            raise _ColumnarIneligible

        def stop_col(key, count):
            spec = plan[key]
            if count == 0:
                return []
            if spec[0] != "stop":
                raise _ColumnarIneligible
            needed_cids.add(spec[2])
            parts = ext_data(spec[2]).split(bytes([spec[1]]))
            if len(parts) - 1 < count:
                raise ValueError(f"{key} stream underrun: {len(parts)-1} < {count}")
            return parts[:count]

        bf = int_col("BF", n)
        cf = int_col("CF", n, default=0)
        rl = int_col("RL", n)
        if bool(np.any(rl < 0)):
            raise ValueError("negative read length")
        u_mask = (cf & 8) != 0  # CF bit 3: sequence unknown, no BA/QS written
        seq_mask = ~u_mask
        r_mask = seq_mask & ((bf & BAM_FUNMAP) == 0)  # mapped: reconstruct vs ref
        ba_run_mask = seq_mask & ~r_mask  # unmapped: bases stored verbatim in BA
        if sh.ref_id == -2 and not plan["has_RI"]:
            raise _ColumnarIneligible  # record loop raises the contract error

        # ---- mapped stage 1: positions + feature columns (before BA offsets:
        # 'i' features and unmapped base runs share the BA block) ----
        mapped = None
        ba_extra = None
        if bool(np.any(r_mask)):
            mapped = self._mapped_columns(
                ch, sh, externals, plan, n, rl, r_mask, int_col, byte_col,
                stop_col, embedded_ref)
            ba_extra = mapped["i_per_rec_full"]

        ba_slab = None
        ba_starts = ba_ends = None
        lens = np.where(ba_run_mask, rl, 0)
        if ba_extra is not None:
            lens = lens + ba_extra
        # a BA run record touches the stream even at rl=0 (the record loop's
        # take(0) still resolves the block), so any run record requires the slab
        if int(lens.sum()) > 0 or bool(np.any(ba_run_mask)):
            spec = plan["BA"]
            if spec[0] != "ext":
                raise _ColumnarIneligible
            needed_cids.add(spec[1])
            ends = np.cumsum(lens)
            starts = ends - lens
            ba_slab = ext_data(spec[1])
            if int(ends[-1]) > len(ba_slab):
                raise ValueError("external stream underrun")
            ba_starts = starts
            ba_ends = ends - (ba_extra if ba_extra is not None else 0)

        q_mask = ((cf & 1) != 0) & seq_mask
        qs_slab = qs_starts = qs_ends = None
        if plan["QS"][0] == "absent":
            q_mask = np.zeros(n, bool)
        elif bool(np.any(q_mask)):
            spec = plan["QS"]
            if spec[0] != "ext":
                raise _ColumnarIneligible
            needed_cids.add(spec[1])
            qlens = np.where(q_mask, rl, 0)
            qends = np.cumsum(qlens)
            qstarts = qends - qlens
            qs_slab = ext_data(spec[1])
            if int(qends[-1]) > len(qs_slab):
                raise ValueError("external stream underrun")
            qs_starts, qs_ends = qstarts, qends

        # names: every record consumes one when the header keeps names; only
        # detached records do otherwise (mirrors the record loop's two sites)
        names = None
        name_mask = None
        if want_names:
            rn_spec = plan["RN"]
            if rn_spec[0] != "absent":
                if ch.read_names_included:
                    name_mask = np.ones(n, bool)
                else:
                    name_mask = (cf & 2) != 0
                    if not bool(np.any(name_mask)):
                        name_mask = None
            if name_mask is not None:
                if rn_spec[0] == "bad":
                    raise _ColumnarIneligible
                needed_cids.add(rn_spec[2])
                try:
                    slab = ext_data(rn_spec[2])
                except UnsupportedCodecError:
                    names = None  # tok3-coded names degrade to dropped names
                else:
                    parts = slab.split(bytes([rn_spec[1]]))
                    k = int(np.count_nonzero(name_mask))
                    if len(parts) - 1 < k:
                        raise ValueError(
                            f"name stream underrun: {len(parts)-1} < {k}")
                    names = [p.decode("ascii", "replace") for p in parts[:k]]

        if sh.embedded_ref_id in needed_cids:
            raise _ColumnarIneligible  # a column block aliased as embedded ref

        # ---- mapped stage 2: reconstructed sequence lanes (need the BA
        # offsets for 'i' operands) ----
        mseq = None
        if mapped is not None:
            mseq = self._mapped_seqs(ch, sh, mapped, ba_slab, ba_starts,
                                     embedded_ref)

        return {
            "n": n, "bf": bf, "rl": rl, "u_mask": u_mask, "r_mask": r_mask,
            "ba_run_mask": ba_run_mask, "q_mask": q_mask,
            "ba_slab": ba_slab, "ba_starts": ba_starts, "ba_ends": ba_ends,
            "qs_slab": qs_slab, "qs_starts": qs_starts, "qs_ends": qs_ends,
            "names": names, "name_mask": name_mask,
            "r_idx": None if mapped is None else mapped["r_idx"],
            "mseq": mseq,
        }

    def _decode_slice_columnar(self, ch, sh, externals, plan,
                               embedded_ref=None) -> List["CramRecord"]:
        """Columnar slice decode materialized as CramRecords (the record-API
        face of _slice_columns; the packed feeder consumes the columns
        directly via iter_seq_chunks). Returns a list, not a generator:
        eligibility must settle before the first yield so the record-loop
        fallback never re-emits records."""
        C = self._slice_columns(ch, sh, externals, plan, embedded_ref)
        if C is None:
            return []
        n = C["n"]
        recon = None
        mseq = C["mseq"]
        if mseq is not None:
            recon = [None] * len(C["r_idx"])
            blob = mseq["blob"].tobytes()
            sf = mseq["starts_f"].tolist()
            ef = mseq["ends_f"].tolist()
            for vj, j in enumerate(np.nonzero(mseq["vec_sel"])[0].tolist()):
                recon[j] = blob[sf[vj] : ef[vj]].decode("ascii", "replace")
            for j, s in mseq["applier"].items():
                recon[j] = s
        ba_slab = C["ba_slab"]
        ba_starts = C["ba_starts"].tolist() if C["ba_starts"] is not None else None
        ba_ends = C["ba_ends"].tolist() if C["ba_ends"] is not None else None
        qs_slab = C["qs_slab"]
        qs_starts = C["qs_starts"].tolist() if C["qs_starts"] is not None else None
        qs_ends = C["qs_ends"].tolist() if C["qs_ends"] is not None else None
        names = C["names"]
        flags = C["bf"].tolist()
        useq = C["u_mask"].tolist()
        recm = C["r_mask"].tolist()
        qm = C["q_mask"].tolist()
        nm = C["name_mask"].tolist() if C["name_mask"] is not None else None
        out: List[CramRecord] = []
        ni = 0
        ri = 0
        for i in range(n):
            if useq[i]:
                seq: str = ""
                quals = None
            else:
                if recm[i]:
                    seq = recon[ri]
                    ri += 1
                else:
                    seq = ba_slab[ba_starts[i] : ba_ends[i]].decode("ascii", "replace")
                quals = list(qs_slab[qs_starts[i] : qs_ends[i]]) if qm[i] else None
            name = None
            if nm is not None and nm[i]:
                if names is not None:
                    name = names[ni]
                ni += 1
            out.append(CramRecord(seq=seq, qual=quals, flag=flags[i], name=name))
        return out

    def _mapped_columns(self, ch, sh, externals, plan, n, rl, r_mask,
                        int_col, byte_col, stop_col, embedded_ref):
        """Stage 1 of columnar mapped reconstruction: decode the position and
        feature columns, classify records into the vectorized X-only lane vs
        the per-record applier lane, and count per-record BA consumption by
        'i' features (the BA block is shared with unmapped base runs, so these
        counts must exist before the BA offsets can)."""
        r_idx = np.nonzero(r_mask)[0]
        nR = len(r_idx)

        # positions: AP is consumed for every record by the record loop; in
        # delta mode it accumulates slice-wide from the slice start
        ap = int_col("AP", n)
        pos = sh.start + np.cumsum(ap) if ch.ap_delta else ap
        ri = int_col("RI", n) if sh.ref_id == -2 else None

        fn = int_col("FN", nR)
        if bool(np.any(fn < 0)):
            raise ValueError("negative feature count")
        F = int(fn.sum())
        fc = byte_col("FC", F)
        fp = int_col("FP", F)
        if F and bool(np.any((fc == ord("B")) | (fc == ord("Q")) | (fc == ord("q")))):
            # B/Q/q consume QS bytes interleaved with the per-record quality
            # runs — the quality slab offsets would be wrong for the rest of
            # the slice
            raise _ColumnarIneligible

        rec_of_feat = np.repeat(np.arange(nR), fn)
        idx_start = np.concatenate([[0], np.cumsum(fn)])[:-1]
        total_fp = np.cumsum(fp)
        before = np.concatenate([[0], total_fp])[idx_start]
        fpos = total_fp - np.repeat(before, fn)  # absolute 1-based read pos

        # operand columns, indexed per code in feature order
        known = b"XSIibDNHP"
        op_idx = np.zeros(F, np.int64)
        counts = {}
        for code in known:
            m = fc == code
            c = int(m.sum())
            counts[code] = c
            if c:
                op_idx[m] = np.arange(c)
        ops = {
            ord("X"): byte_col("BS", counts[ord("X")]),
            ord("D"): int_col("DL", counts[ord("D")]),
            ord("N"): int_col("RS", counts[ord("N")]),
            ord("H"): int_col("HC", counts[ord("H")]),
            ord("P"): int_col("PD", counts[ord("P")]),
            ord("S"): stop_col("SC", counts[ord("S")]),
            ord("I"): stop_col("IN", counts[ord("I")]),
            ord("b"): stop_col("BB", counts[ord("b")]),
        }

        # 'i' features: per-record BA byte counts + within-record ordinals
        m_i = fc == ord("i")
        i_per_rec = np.bincount(rec_of_feat[m_i], minlength=nR) if F else np.zeros(nR, np.int64)
        c_i = np.cumsum(m_i) if F else np.zeros(0, np.int64)
        before_i = np.concatenate([[0], c_i])[idx_start]
        iord = (c_i - np.repeat(before_i, fn)) - 1  # valid at m_i positions
        i_per_rec_full = np.zeros(n, np.int64)
        i_per_rec_full[r_idx] = i_per_rec

        # vectorized-lane eligibility per record: all features X, positions
        # strictly increasing and inside the read (the record loop's cursor
        # semantics silently skip out-of-order features — applier territory)
        rl_R = rl[r_idx]
        widx = np.arange(F) - np.repeat(idx_start, fn)
        bad_feat = (
            (fc != ord("X"))
            | (fpos < 1)
            | (fpos > rl_R[rec_of_feat])
            | ((widx > 0) & (fp <= 0))
        )
        rec_applier = (np.bincount(rec_of_feat[bad_feat], minlength=nR) > 0) if F else np.zeros(nR, bool)

        return {
            "r_idx": r_idx, "nR": nR, "pos": pos, "ri": ri, "fn": fn,
            "fc": fc, "fpos": fpos, "rec_of_feat": rec_of_feat,
            "idx_start": idx_start, "op_idx": op_idx, "ops": ops,
            "iord": iord, "i_per_rec_full": i_per_rec_full,
            "rec_applier": rec_applier, "rl_R": rl_R,
        }

    def _ref_bytes(self, ref: str, cache_key):
        """ASCII bytes of a reference (cached per ref id), or None when the
        reference holds non-ASCII characters (vector lane would mangle them)."""
        cache = self.__dict__.setdefault("_refcache", {})
        hit = cache.get(cache_key)
        if hit is not None and hit[0] == len(ref):
            return hit[1]
        rb = (np.frombuffer(ref.encode("ascii"), np.uint8)
              if ref.isascii() else None)
        if cache_key is not None:
            cache[cache_key] = (len(ref), rb)
        return rb

    def _mapped_seqs(self, ch, sh, mapped, ba_slab, ba_starts, embedded_ref):
        """Stage 2: reconstruct sequence bytes for every mapped record.

        Returns a lane struct instead of per-record strings so the packed-chunk
        path can consume the vectorized lane's flat blob directly:
        ``vec_sel`` bool[nR] (vectorized X-only lane membership),
        ``blob`` uint8[] + ``starts_f``/``ends_f`` (per-vec-record segments, in
        ascending record order), ``applier`` {R-index → str} for the rest."""
        emb_str = (embedded_ref.decode("ascii", "replace")
                   if embedded_ref is not None else None)
        r_idx = mapped["r_idx"]
        nR = mapped["nR"]
        pos, rl_R = mapped["pos"], mapped["rl_R"]
        fc, fpos, fn = mapped["fc"], mapped["fpos"], mapped["fn"]
        rec_of_feat, idx_start = mapped["rec_of_feat"], mapped["idx_start"]
        op_idx, ops, iord = mapped["op_idx"], mapped["ops"], mapped["iord"]
        rec_applier = mapped["rec_applier"].copy()
        sub = _sub_table(ch)
        applier: Dict[int, str] = {}

        slice_ref = None  # resolved lazily; (ref, ref_off)
        vec_ok = emb_str is not None or sh.ref_id != -2
        if vec_ok and not bool(np.all(rec_applier)):
            ref, ref_off = self._resolve_slice_ref(ch, sh, emb_str, sh.ref_id)
            slice_ref = (ref, ref_off)
            key = None if emb_str is not None else ("ref", sh.ref_id)
            ref_b = self._ref_bytes(ref, key)
            if ref_b is None:
                vec_ok = False  # non-ASCII reference: applier lane everywhere
        if not vec_ok:
            rec_applier[:] = True

        flat = np.zeros(0, np.uint8)
        starts_f = ends_f = np.zeros(0, np.int64)
        vec_sel = ~rec_applier
        if bool(np.any(vec_sel)):
            vecpos = np.full(nR, -1, np.int64)
            vecpos[vec_sel] = np.arange(int(vec_sel.sum()))
            rlv = rl_R[vec_sel]
            startsv = pos[r_idx[vec_sel]] - ref_off
            tot = int(rlv.sum())
            ends_f = np.cumsum(rlv)
            starts_f = ends_f - rlv
            # one repeat: base-j of vec-record v reads ref[startsv[v] + j], and
            # flat position = starts_f[v] + j, so gather index = position +
            # (startsv - starts_f) repeated per record
            gidx = np.arange(tot) + np.repeat(startsv - starts_f, rlv)
            if len(ref_b):
                lo = int(gidx.min()) if tot else 0
                hi = int(gidx.max()) if tot else -1
                if 0 <= lo and hi < len(ref_b):
                    flat = ref_b[gidx]  # fully in-bounds: plain gather
                else:
                    ok = (gidx >= 0) & (gidx < len(ref_b))
                    flat = np.where(ok, ref_b[np.clip(gidx, 0, len(ref_b) - 1)],
                                    np.uint8(ord("N"))).astype(np.uint8)
            else:
                flat = np.full(tot, ord("N"), np.uint8)
            fm = (fc == ord("X")) & vec_sel[rec_of_feat] if len(fc) else np.zeros(0, bool)
            if bool(np.any(fm)):
                lut = np.full((256, 4), ord("N"), np.uint8)
                for (rb_ch, v), alt in sub.items():
                    lut[ord(rb_ch), v] = ord(alt)
                    lut[ord(rb_ch.lower()), v] = ord(alt)
                at = starts_f[vecpos[rec_of_feat[fm]]] + (fpos[fm] - 1)
                code = mapped["ops"][ord("X")][op_idx[fm]]
                rbb = flat[at]
                alt = np.where(code <= 3,
                               lut[rbb, np.minimum(code, 3)], np.uint8(ord("N")))
                flat[at] = alt
        if bool(np.any(rec_applier)):
            fc_l = fc.tolist()
            fpos_l = fpos.tolist()
            oi = op_idx.tolist()
            iord_l = iord.tolist()
            fn_l = fn.tolist()
            start_l = idx_start.tolist()
            for j in np.nonzero(rec_applier)[0].tolist():
                gi = int(r_idx[j])
                if emb_str is not None:
                    ref_j, off_j = emb_str, sh.start
                elif sh.ref_id == -2:
                    ref_j, off_j = self._resolve_slice_ref(
                        ch, sh, None, int(mapped["ri"][gi]))
                else:
                    if slice_ref is None:
                        slice_ref = self._resolve_slice_ref(ch, sh, None, sh.ref_id)
                    ref_j, off_j = slice_ref
                feats = []
                for k in range(start_l[j], start_l[j] + fn_l[j]):
                    code = chr(fc_l[k])
                    if code == "X":
                        op = int(ops[ord("X")][oi[k]])
                    elif code in ("S", "I", "b"):
                        op = ops[ord(code)][oi[k]]
                    elif code in ("D", "N", "H", "P"):
                        op = int(ops[ord(code)][oi[k]])
                    elif code == "i":
                        op = ba_slab[ba_starts[gi] + iord_l[k]]
                    else:
                        raise ValueError(f"unsupported read feature {code!r}")
                    feats.append((code, fpos_l[k], op))
                applier[j] = _apply_features(ref_j, off_j, int(pos[gi]),
                                             int(rl_R[j]), feats, sub)
        return {"vec_sel": vec_sel, "blob": flat, "starts_f": starts_f,
                "ends_f": ends_f, "applier": applier}

    def _decode_slice(self, ch, sh, core, externals, embedded_ref, cont_ref,
                      with_pos: bool = False):
        """Record-loop slice decode. ``with_pos=True`` (the region-query path,
        io/crai.py) yields ``(record, ref_id, pos0, ref_span)`` tuples instead of
        bare records — positions never surface on CramRecord so the columnar and
        record paths stay field-identical."""
        dec: Dict[str, _Decoder] = {}

        def D(key) -> Optional[_Decoder]:
            if key not in dec:
                enc = ch.data_series.get(key)
                dec[key] = _Decoder(enc, core, externals) if enc else None
            return dec[key]

        sub = _sub_table(ch)

        # decode the embedded reference ONCE per slice (was once per record)
        emb_ref_str = (
            embedded_ref.decode("ascii", "replace") if embedded_ref is not None else None
        )
        tag_state = self._tag_state(ch)
        last_pos = sh.start
        for _ in range(sh.n_records):
            bf = D("BF").read_int()
            cf = D("CF").read_int() if D("CF") else 0
            # multi-reference is a SLICE property: RI is consumed per record only when
            # the slice header says -2; single-ref slices inside a -2 container use the
            # slice's own ref id (spec §8.5)
            ref_id = sh.ref_id
            if sh.ref_id == -2:
                if D("RI") is None:
                    raise ValueError("multi-ref slice without an RI data series")
                ref_id = D("RI").read_int()
            rl = D("RL").read_int()
            if ch.ap_delta:
                delta = D("AP").read_int()
                last_pos = last_pos + delta
                pos0 = last_pos
            else:
                pos0 = D("AP").read_int()
            if D("RG"):
                D("RG").read_int()
            name = None
            if ch.read_names_included and D("RN"):
                try:
                    name = D("RN").read_bytes().decode("ascii", "replace")
                except UnsupportedCodecError:
                    name = None  # tok3-coded names: drop (feeder needs seq/qual/flag)
            # mate
            if cf & 2:  # detached
                D("MF").read_int()
                if not ch.read_names_included and D("RN"):
                    try:
                        name = D("RN").read_bytes().decode("ascii", "replace")
                    except UnsupportedCodecError:
                        name = None
                D("NS").read_int()
                D("NP").read_int()
                D("TS").read_int()
            elif cf & 4:  # mate downstream
                D("NF").read_int()
            # tags
            tl = D("TL").read_int() if D("TL") else 0
            self._skip_tags(ch, tl, core, externals, tag_state)

            unmapped = bool(bf & BAM_FUNMAP)
            if cf & 8:
                # CF bit 3: sequence is unknown ('*') — no base or quality series were
                # written for this record; fabricating bases from the reference (or
                # consuming series that are not there) would desync the whole slice
                if not unmapped and D("MQ"):
                    D("MQ").read_int()
                seq, quals = "", None
                # no features to measure: the padded read length is the best span
                rspan = max(rl, 1)
            elif not unmapped:
                seq, rspan = self._reconstruct(ch, sh, D, sub, pos0, rl,
                                               emb_ref_str, ref_id)
                if D("MQ"):
                    D("MQ").read_int()
                # CF bit 0 = per-base qualities stored as an RL-byte QS run
                quals = list(D("QS").read_bytes(rl)) if (cf & 1) and D("QS") else None
            else:
                ba = D("BA")
                if ba is None:
                    # mirror the RI check in _decode_slice: a reader contract violation
                    # must surface as ValueError, not AttributeError
                    raise ValueError("unmapped record with bases but no BA data series")
                bases = ba.read_byte_run(rl)
                seq = bases.decode("ascii", "replace")
                quals = list(D("QS").read_bytes(rl)) if (cf & 1) and D("QS") else None
                rspan = 1  # placed-unmapped overlaps at its coordinate (io/bai.py)
            rec = CramRecord(seq=seq, qual=quals, flag=bf, name=name)
            if with_pos:
                yield rec, ref_id, pos0, rspan
            else:
                yield rec

    @staticmethod
    def _tag_state(ch):
        """Per-slice tag machinery: TD lines split once, decoders cached per tag key."""
        td = ch.preservation.get("TD", b"\x00")
        lines = td.split(b"\x00")
        if td.endswith(b"\x00"):
            lines = lines[:-1]  # trailing NUL terminator, not a phantom extra line
        return {"lines": lines, "decoders": {}}

    def _skip_tags(self, ch, tl, core, externals, tag_state):
        lines = tag_state["lines"]
        if tl >= len(lines):
            # silently skipping would leave the record's tag bytes unconsumed and desync
            # every later record in the slice
            raise ValueError(f"TL {tl} out of range ({len(lines)} tag-dictionary lines)")
        line = lines[tl]
        decoders = tag_state["decoders"]
        # each tag is 3 bytes: two-letter key + type
        for i in range(0, len(line) - 2, 3):
            key = (line[i] << 16) | (line[i + 1] << 8) | line[i + 2]
            d = decoders.get(key)
            if d is None:
                enc = ch.tag_encodings.get(key)
                if enc is None:
                    raise ValueError(f"tag {line[i:i+3]!r} has no encoding")
                d = decoders[key] = _Decoder(enc, core, externals)
            d.read_bytes()

    def _resolve_slice_ref(self, ch, sh, emb_ref_str, ref_id) -> Tuple[str, int]:
        """(reference string, offset of its first base in 1-based ref coords)."""
        if emb_ref_str is not None:
            return emb_ref_str, sh.start  # embedded ref starts at the slice start
        ref = self._ref_seq(ref_id)
        if ref is None:
            if ch.preservation.get("RR", True):
                raise ValueError(
                    f"slice needs reference sequence {ref_id}; pass reference="
                )
            # RR=false (no-ref CRAM, e.g. samtools --output-fmt-option no_ref):
            # every base is feature-coded; positions the features miss decode as N
            ref = ""
        return ref, 1  # CRAM positions are 1-based

    def _reconstruct(self, ch, sh, D, sub, pos0, rl, emb_ref_str,
                     ref_id) -> Tuple[str, int]:
        """→ (sequence, reference span). Span = reference bases the alignment
        consumes (read length minus read-only features plus ref-only features,
        min 1) — the CRAM analog of io/bai.record_ref_span for region overlap."""
        ref, ref_off = self._resolve_slice_ref(ch, sh, emb_ref_str, ref_id)
        fn = D("FN").read_int()
        feats = []
        fpos = 0
        read_only = 0
        ref_only = 0
        for _ in range(fn):
            code = chr(D("FC").read_byte())
            fpos += D("FP").read_int()
            op = self._feat_operand(code, D)
            feats.append((code, fpos, op))
            if code in ("S", "I"):  # soft clip / insertion: read bases, no ref
                read_only += len(op)
            elif code == "i":  # single inserted base
                read_only += 1
            elif code in ("D", "N"):  # deletion / ref skip: ref bases, no read
                ref_only += op
        span = max(rl - read_only + ref_only, 1)
        return _apply_features(ref, ref_off, pos0, rl, feats, sub), span

    def _feat_operand(self, code, D):
        if code == "X":
            return D("BS").read_byte()
        if code == "S":
            return D("SC").read_bytes()
        if code == "I":
            return D("IN").read_bytes()
        if code == "i":
            return D("BA").read_byte()
        if code == "b":
            return D("BB").read_bytes()
        if code == "D":
            return D("DL").read_int()
        if code == "N":
            return D("RS").read_int()
        if code == "H":
            return D("HC").read_int()
        if code == "P":
            return D("PD").read_int()
        if code == "B":
            return (D("BA").read_byte(), D("QS").read_byte())
        if code == "q":
            return D("QQ").read_bytes()
        if code == "Q":
            return D("QS").read_byte()
        raise ValueError(f"unsupported read feature {code!r}")


def load_reference(fasta_path: str) -> Dict[str, str]:
    """FASTA → {sequence name: sequence}. Names (first whitespace-delimited token of each
    header) are matched against the CRAM's @SQ SN: names — NOT file order, which need not
    agree between the FASTA and the CRAM header."""
    from denovo_kmer_tpu_torch.io.fasta import read_fasta

    # read_fasta already yields the first whitespace-delimited token ('' for bare '>')
    return {name: seq for name, seq in read_fasta(fasta_path)}


def read_cram_records(path: str, reference: Optional[str] = None):
    """Iterate CRAM records from a path/URL, BamRecord-compatible (seq/qual/flag)."""
    from denovo_kmer_tpu_torch.io.fasta import load_reference_indexed
    from denovo_kmer_tpu_torch.io.remote import open_binary

    ref = load_reference_indexed(reference) if reference else None
    with open_binary(path) as f:
        yield from CramReader(f, reference=ref)


def _chunk_from_columns(C, flag_mask: int, max_read_len: int, with_quals: bool):
    """ops.pack.SeqChunk from one slice's columns (_slice_columns): flag
    filter + length truncation, then sequence bytes spliced from their source
    slabs with two fancy-index passes per slab — per-record Python survives
    only on the rare applier lane (clips/indels)."""
    from denovo_kmer_tpu_torch.ops.pack import SeqChunk

    n = C["n"]
    keep = (C["bf"] & flag_mask) == 0
    kept = np.nonzero(keep)[0]
    nk = len(kept)
    rl = C["rl"]
    # per-record sequence source: -1 = no sequence, 0 = BA slab, 1 = vec blob,
    # 2 = applier string
    src = np.full(n, -1, np.int8)
    start = np.zeros(n, np.int64)
    seq_len = np.where(C["u_mask"], 0, rl)
    if C["ba_starts"] is not None:
        run = C["ba_run_mask"]
        src[run] = 0
        start[run] = C["ba_starts"][run]
    mseq = C["mseq"]
    by_rec = {}
    if mseq is not None:
        r_idx = C["r_idx"]
        vrec = r_idx[mseq["vec_sel"]]
        src[vrec] = 1
        start[vrec] = mseq["starts_f"]
        for j, s in mseq["applier"].items():
            rec = int(r_idx[j])
            src[rec] = 2
            by_rec[rec] = s
            # the applier produces the final string — its length is
            # authoritative (clips/pads may disagree with RL in theory)
            seq_len[rec] = len(s)
    L = np.minimum(seq_len[kept], max_read_len)
    ends = np.cumsum(L)
    starts_dst = ends - L
    total = int(ends[-1]) if nk else 0
    src_k = src[kept]
    start_k = start[kept]

    def _contiguous_view(slab, st, ln):
        """One slab view when the per-record offsets are consecutive — the
        dominant archive shapes (an unfiltered untruncated unmapped slice is
        one BA run; a vec-lane mapped slice is the blob in record order) need
        zero index arrays and zero copies."""
        fin = st + ln
        if not bool(np.all(st[1:] == fin[:-1])):
            return None
        arr = (slab if isinstance(slab, np.ndarray)
               else np.frombuffer(slab, np.uint8))
        return arr[int(st[0]) : int(fin[-1])]

    one = None
    live = np.nonzero(L > 0)[0]
    if not by_rec and len(live):
        for sid, slab in ((0, C["ba_slab"]),
                          (1, None if mseq is None else mseq["blob"])):
            if slab is not None and bool(np.all(src_k[live] == sid)):
                one = _contiguous_view(slab, start_k[live], L[live])
                break
    elif not len(live):
        one = np.empty(0, np.uint8)
    if one is not None:
        flat = one
    else:
        flat = np.empty(total, np.uint8)
        for sid, slab in ((0, C["ba_slab"]),
                          (1, None if mseq is None else mseq["blob"])):
            m = (src_k == sid) & (L > 0)
            if not bool(np.any(m)):
                continue
            slab_arr = (slab if isinstance(slab, np.ndarray)
                        else np.frombuffer(slab, np.uint8))
            Lm = L[m]
            seg_ends = np.cumsum(Lm)
            within = np.arange(int(seg_ends[-1])) - np.repeat(seg_ends - Lm, Lm)
            rep_src = np.repeat(start_k[m], Lm) + within
            rep_dst = np.repeat(starts_dst[m], Lm) + within
            flat[rep_dst] = slab_arr[rep_src]
        m2 = np.nonzero(src_k == 2)[0]
        if len(m2):
            ds = starts_dst.tolist()
            Ll = L.tolist()
            kl = kept.tolist()
            for p in m2.tolist():
                b = by_rec[kl[p]].encode("ascii", "replace")[: Ll[p]]
                flat[ds[p] : ds[p] + len(b)] = np.frombuffer(b, np.uint8)
    qflat = None
    if with_quals and C["qs_slab"] is not None and total:
        qm = C["q_mask"][kept] & (L > 0)
        if bool(np.any(qm)):
            qs = np.frombuffer(C["qs_slab"], np.uint8)
            qst = C["qs_starts"][kept]
            qflat = None
            if bool(np.all(qm == (L > 0))):
                # every byte-bearing record stores qualities: same contiguity
                # shortcut as the sequence lane
                live = np.nonzero(L > 0)[0]
                st = qst[live]
                fin = st + L[live]
                if bool(np.all(st[1:] == fin[:-1])):
                    qflat = qs[int(st[0]) : int(fin[-1])]
            if qflat is None:
                # 0xFF = "no stored quality" → passes any min_base_quality
                # ≤ 255, same outcome as the record path's qual=None
                qflat = np.full(total, 0xFF, np.uint8)
                Lm = L[qm]
                seg_ends = np.cumsum(Lm)
                within = (np.arange(int(seg_ends[-1]))
                          - np.repeat(seg_ends - Lm, Lm))
                rep_src = np.repeat(qst[qm], Lm) + within
                rep_dst = np.repeat(starts_dst[qm], Lm) + within
                qflat[rep_dst] = qs[rep_src]
    return SeqChunk(flat=flat, lens=L.astype(np.int64), qflat=qflat)


def _chunk_from_records(records, flag_mask: int, max_read_len: int,
                        with_quals: bool):
    """ops.pack.SeqChunk from a record stream — the fallback wrapper that
    keeps the packed feeder uniform when a slice is columnar-ineligible."""
    from denovo_kmer_tpu_torch.ops.pack import SeqChunk

    seqs: List[bytes] = []
    qparts: List[bytes] = []
    any_q = False
    for r in records:
        if r.flag & flag_mask:
            continue
        b = r.seq.encode("ascii", "replace")[:max_read_len]
        seqs.append(b)
        if not with_quals:
            continue
        q = r.qual
        if q is None:
            qparts.append(b"\xff" * len(b))
        else:
            if len(q) < len(r.seq):
                # same contract as pack_seqs: malformed record errors before
                # truncation can mask it
                raise ValueError(
                    f"quality string shorter than sequence ({len(q)} < "
                    f"{len(r.seq)}) — malformed input record")
            any_q = True
            qparts.append(bytes(q[: len(b)]))
    n = len(seqs)
    lens = (np.fromiter((len(b) for b in seqs), np.int64, n)
            if n else np.zeros(0, np.int64))
    flat = np.frombuffer(b"".join(seqs), np.uint8)
    qflat = (np.frombuffer(b"".join(qparts), np.uint8)
             if (with_quals and any_q) else None)
    return SeqChunk(flat=flat, lens=lens, qflat=qflat)


# ---------------------------------------------------------------------------
# writer (fixture-grade, deliberately different profile from the reader's general path:
# all-EXTERNAL encodings, absolute AP, one slice per container)
# ---------------------------------------------------------------------------

class _ExtBuf:
    def __init__(self):
        self.buf = bytearray()
        self.lens: List[int] = []  # per-raw()-call sizes (fqz needs QS record lengths)

    def itf8(self, v: int):
        self.buf += itf8_encode(v)

    def byte(self, b: int):
        self.buf.append(b & 0xFF)

    def raw(self, b: bytes):
        self.buf += b
        self.lens.append(len(b))


# fixed external content ids per data series (writer profile)
_W_IDS = {
    "BF": 1, "CF": 2, "RL": 3, "AP": 4, "RG": 5, "RN": 6, "MF": 7, "NS": 8,
    "NP": 9, "TS": 10, "TL": 11, "FN": 12, "FP": 13, "FC": 14, "BS": 15,
    "DL": 16, "BA": 17, "QS": 18, "MQ": 19, "SC": 20, "IN": 21, "RS": 22,
    "HC": 23, "PD": 24, "BB": 25, "RI": 26,
}


def _enc_external(cid: int) -> bytes:
    params = itf8_encode(cid)
    return itf8_encode(E_EXTERNAL) + itf8_encode(len(params)) + params


def _enc_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + itf8_encode(cid)
    return itf8_encode(E_BYTE_ARRAY_STOP) + itf8_encode(len(params)) + params


def _enc_huffman(alphabet, lens) -> bytes:
    params = bytearray(itf8_encode(len(alphabet)))
    for v in alphabet:
        params += itf8_encode(v)
    params += itf8_encode(len(lens))
    for l in lens:
        params += itf8_encode(l)
    return itf8_encode(E_HUFFMAN) + itf8_encode(len(params)) + bytes(params)


def _enc_beta(offset: int, nbits: int) -> bytes:
    params = itf8_encode(offset) + itf8_encode(nbits)
    return itf8_encode(E_BETA) + itf8_encode(len(params)) + params


class _BitWriter:
    """MSB-first core bit stream (the mirror of _BitReader)."""

    def __init__(self):
        self.buf = bytearray()
        self.bit = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            if self.bit == 0:
                self.buf.append(0)
            if (v >> i) & 1:
                self.buf[-1] |= 1 << (7 - self.bit)
            self.bit = (self.bit + 1) & 7

    def getvalue(self) -> bytes:
        return bytes(self.buf)


def _huffman_codes(values):
    """Equal-length canonical codes over the distinct values (a valid prefix set;
    the reader rebuilds them by (len, symbol) order, spec §12.4)."""
    alphabet = sorted(set(values))
    L = max((len(alphabet) - 1).bit_length(), 1)
    lens = [L] * len(alphabet)
    codes = {sym: i for i, sym in enumerate(alphabet)}  # canonical: 0,1,2,… at len L
    return alphabet, lens, codes, L


def _compression_header_blob(mapped: bool, multiref: bool = False) -> bytes:
    # preservation map: RN=1 (names kept), AP=0 (absolute positions), RR per mode,
    # SM default matrix, TD = one empty tag line
    pres = bytearray()
    entries = [(b"RN", bytes([1])), (b"AP", bytes([0])), (b"RR", bytes([1 if mapped else 0])),
               (b"SM", bytes([0x1B] * 5)), (b"TD", itf8_encode(1) + b"\x00")]
    pres += itf8_encode(len(entries))
    for k, v in entries:
        pres += k + v

    series = bytearray()
    encs: List[Tuple[bytes, bytes]] = []
    keys = ["BF", "CF", "RL", "AP", "MF", "NS", "NP", "TS", "TL",
            "FN", "FP", "BS", "DL", "BA", "QS", "MQ", "FC", "RS",
            "HC", "PD"]
    if multiref:
        keys.insert(4, "RI")  # per-record reference id (slices written as -2)
    for key in keys:
        encs.append((key.encode(), _enc_external(_W_IDS[key])))
    encs.append((b"RN", _enc_byte_array_stop(0, _W_IDS["RN"])))
    encs.append((b"SC", _enc_byte_array_stop(0, _W_IDS["SC"])))
    encs.append((b"IN", _enc_byte_array_stop(0, _W_IDS["IN"])))
    encs.append((b"BB", _enc_byte_array_stop(0, _W_IDS["BB"])))
    series += itf8_encode(len(encs))
    for k, e in encs:
        series += k + e

    tags = itf8_encode(0)

    out = bytearray()
    for part in (bytes(pres), bytes(series), bytes(tags)):
        out += itf8_encode(len(part)) + part
    return bytes(out)


def _slice_header_blob(ref_id, start, span, n_records, counter, n_blocks, ids,
                       md5: bytes = _ZERO_MD5):
    out = bytearray()
    out += itf8_encode(ref_id)
    out += itf8_encode(start)
    out += itf8_encode(span)
    out += itf8_encode(n_records)
    out += ltf8_encode(counter)
    out += itf8_encode(n_blocks)
    out += itf8_encode(len(ids))
    for i in ids:
        out += itf8_encode(i)
    out += itf8_encode(-1)  # no embedded reference
    out += md5  # reference-span MD5 (all-zero = unset, spec §8.5)
    return bytes(out)


def _container(out, body_blocks: bytes, ref_id: int, start: int, span: int,
               n_rec: int, counter: int, n_blocks: int, landmarks: List[int]):
    head = bytearray()
    head += struct.pack("<i", len(body_blocks))
    head += itf8_encode(ref_id)
    head += itf8_encode(start)
    head += itf8_encode(span)
    head += itf8_encode(n_rec)
    head += ltf8_encode(counter)
    head += ltf8_encode(0)  # bases
    head += itf8_encode(n_blocks)
    head += itf8_encode(len(landmarks))
    for l in landmarks:
        head += itf8_encode(l)
    head += struct.pack("<I", zlib.crc32(bytes(head)))
    out.write(bytes(head))
    out.write(body_blocks)


def write_cram(
    path: str,
    records,  # iterable of (seq, qual|None, flag) — unmapped profile
    sam_header: str = "@HD\tVN:1.6\n",
    mapped: Optional[List[Tuple[str, int]]] = None,  # [(seq, 1-based pos)] vs reference
    reference: Optional[str] = None,  # reference sequence string (mapped profile)
    method: int = M_GZIP,
    rans_order: int = 0,
    reads_per_container: int = 1000,
    slices_per_container: int = 1,
    version: Tuple[int, int] = (3, 0),
    profile: str = "external",
) -> None:
    """Write a CRAM 3.0 or 3.1 file. Two profiles:

    - unmapped (``records``): sequences via the BA series — no reference needed.
    - mapped (``mapped`` + ``reference``): X-substitution features computed against the
      reference; exercises the reader's reconstruction path. Tuples are
      ``(seq, pos1)`` / ``(seq, pos1, ref_id)`` or, with per-record flags and
      qualities preserved (``view --format cram``), ``(seq, pos1, flag, qual)`` /
      ``(seq, pos1, ref_id, flag, qual)``; records carrying BAM_FUNMAP ride the
      BA byte series inside the positional slice (ref_id -1 allowed for them).

    ``version=(3, 1)`` with ``method=M_RANSNX16`` (or ``M_ARITH``) exercises the 3.1
    block codecs end to end (io/rans_nx16.py, io/arith.py).

    ``profile="core"`` (unmapped only) writes BF/RL as BETA bit fields and CF as
    canonical-Huffman codes in the CORE block instead of EXTERNAL byte streams —
    the core-block-heavy shape htslib emits with small alphabets, exercising the
    reader's bit-stream lane end to end.
    """
    if version not in ((3, 0), (3, 1)):
        raise ValueError(f"unsupported CRAM version {version}")
    if method in (M_RANSNX16, M_ARITH, M_FQZCOMP, M_TOK3) and version == (3, 0):
        raise ValueError("rANS Nx16 / arith / fqzcomp / tok3 blocks require CRAM 3.1")
    if profile not in ("external", "core"):
        raise ValueError(f"unknown CRAM writer profile {profile!r}")
    if profile == "core" and mapped is not None:
        raise ValueError("profile='core' is implemented for the unmapped profile")
    counter = 0
    with open(path, "wb") as f:
        f.write(CRAM_MAGIC + bytes(version) + b"\x00" * 20)
        hdr = sam_header.encode()
        blob = struct.pack("<i", len(hdr)) + hdr
        bio = _io.BytesIO()
        write_block(bio, M_RAW, CT_FILE_HEADER, 0, blob)
        _container(f, bio.getvalue(), 0, 0, 0, 0, 0, 1, [0])

        if mapped is not None:
            assert reference is not None, "mapped profile needs the reference"
            multiref = bool(mapped) and len(mapped[0]) in (3, 5)
            chunks = [mapped[i : i + reads_per_container]
                      for i in range(0, len(mapped), reads_per_container)]
            for chunk in chunks:
                if multiref:
                    # [(seq, pos1, ref_id)] + reference as {ref_id: sequence}:
                    # slices written as ref -2 with a per-record RI series
                    _write_multiref_container(f, chunk, reference, counter,
                                              method, rans_order)
                else:
                    _write_mapped_container(f, chunk, reference, counter,
                                            method, rans_order)
                counter += len(chunk)
        else:
            recs = list(records)
            per_slice = max(reads_per_container // max(slices_per_container, 1), 1)
            chunks = [recs[i : i + per_slice]
                      for i in range(0, len(recs), per_slice)]
            if profile == "core":
                for chunk in chunks:
                    _write_unmapped_container_core(f, chunk, counter, method,
                                                   rans_order)
                    counter += len(chunk)
            else:
                for g in range(0, len(chunks), slices_per_container):
                    group = chunks[g : g + slices_per_container]
                    _write_unmapped_container(f, group, counter, method, rans_order)
                    counter += sum(len(c) for c in group)

        # EOF container: ref -1, no records, single empty compression-header block
        bio = _io.BytesIO()
        write_block(bio, M_RAW, CT_COMPRESSION_HEADER, 0,
                    itf8_encode(1) + itf8_encode(0)
                    + itf8_encode(1) + itf8_encode(0)
                    + itf8_encode(1) + itf8_encode(0))
        _container(f, bio.getvalue(), -1, 4542278, 0, 0, 0, 1, [0])


def _sub_code(ref_base: str, alt_base: str) -> int:
    row = 0x1B  # default matrix row: codes 0,1,2,3 in alt order
    alts = [b for b in _SUB_BASES if b != ref_base]
    j = alts.index(alt_base)
    return (row >> (6 - 2 * j)) & 3


def _slice_blob(ext: Dict[str, _ExtBuf], n_rec: int, ref_id: int, start: int,
                span: int, counter: int, method: int, rans_order: int,
                md5: bytes = _ZERO_MD5, core: bytes = b"") -> Tuple[bytes, int]:
    """One slice's blocks (slice header + core + used externals) → (bytes, n_blocks)."""
    used = [(k, b) for k, b in ext.items() if b.buf]
    ids = [_W_IDS[k] for k, _ in used]
    sh = _slice_header_blob(ref_id, start, span, n_rec, counter, 1 + len(used), ids,
                            md5)
    bio = _io.BytesIO()
    write_block(bio, M_RAW, CT_SLICE_HEADER, 0, sh)
    write_block(bio, M_RAW, CT_CORE, 0, core)
    for k, b in used:
        write_block(bio, _METHOD_OVERRIDES.get(k, method), CT_EXTERNAL,
                    _W_IDS[k], bytes(b.buf), rans_order=rans_order,
                    lens=b.lens if k == "QS" else None)
    return bio.getvalue(), 2 + len(used)


def _norm_mapped_rec(rec, base_len):
    """Normalize a mapped-profile record tuple to (seq, pos1, [rid,] flag, qual):
    the short historical forms carry flag=0 / qual=None (flags/quals were added
    for `view --format cram`, which must round-trip the engine view exactly)."""
    if len(rec) == base_len:
        return (*rec, 0, None)
    if len(rec) == base_len + 2:
        return rec
    raise ValueError(
        f"mapped record tuple of length {len(rec)}; expected {base_len} "
        f"(seq, pos1{', ref_id' if base_len == 3 else ''}) or {base_len + 2} "
        f"(+ flag, qual)"
    )


def _mapped_record_series(ext, seq, pos1, flag, qual, reference, name):
    """Per-record series shared by the mapped and multi-ref container writers:
    BF carries the true flag; mapped records encode X-substitution features vs
    the reference, unmapped (BAM_FUNMAP) records ride the BA byte series
    (the reader dispatches on BF per record — _decode_slice / _mapped_columns)."""
    unmapped = bool(flag & BAM_FUNMAP)
    ext["BF"].itf8(flag)
    ext["CF"].itf8(2 | (1 if qual is not None else 0))  # detached (+ quals)
    ext["RL"].itf8(len(seq))
    ext["AP"].itf8(pos1)
    ext["RN"].raw(name + b"\x00")
    ext["MF"].itf8(0)
    ext["NS"].itf8(-1)
    ext["NP"].itf8(0)
    ext["TS"].itf8(0)
    ext["TL"].itf8(0)
    if unmapped:
        for ch_ in seq:
            ext["BA"].byte(ord(ch_))
    else:
        if pos1 < 1 or pos1 - 1 + len(seq) > len(reference):
            raise ValueError(
                f"mapped record at pos {pos1} (len {len(seq)}) exceeds the "
                f"reference ({len(reference)} bp)"
            )
        feats = []
        for j, b in enumerate(seq):
            rb = reference[pos1 - 1 + j]
            if b != rb:
                feats.append((j + 1, rb, b))
        ext["FN"].itf8(len(feats))
        last = 0
        for rpos, rb, alt in feats:
            ext["FP"].itf8(rpos - last)
            ext["FC"].byte(ord("X"))
            ext["BS"].byte(_sub_code(rb, alt))
            last = rpos
        ext["MQ"].itf8(30)
    if qual is not None:
        ext["QS"].raw(bytes(qual))


def _write_multiref_container(f, chunk, references, counter, method, rans_order):
    """One multi-reference container (slice ref_id -2, per-record RI series):
    ``chunk`` = [(seq, pos1, ref_id)] or [(seq, pos1, ref_id, flag, qual)],
    ``references`` = {ref_id: sequence}. Unplaced records (ref_id -1, which must
    carry BAM_FUNMAP) never touch the references dict."""
    ext: Dict[str, _ExtBuf] = {k: _ExtBuf() for k in _W_IDS}
    for i, rec in enumerate(chunk):
        seq, pos1, rid, flag, qual = _norm_mapped_rec(rec, 3)
        reference = references[rid] if not (flag & BAM_FUNMAP) else None
        ext["RI"].itf8(rid)
        _mapped_record_series(ext, seq, pos1, flag, qual, reference,
                              f"m{counter + i}".encode())
    # spec: multi-ref slices/containers carry ref -2 with start/span 0
    _write_series_blocks(f, ext, len(chunk), -2, 0, 0, counter, method,
                         rans_order, mapped=True, multiref=True)


def _write_series_blocks(f, ext: Dict[str, _ExtBuf], n_rec: int, ref_id: int,
                         start: int, span: int, counter: int, method: int,
                         rans_order: int, mapped: bool, extra_slices=(),
                         multiref: bool = False, ref_md5: bytes = _ZERO_MD5):
    """Emit one container: compression header + one slice from ``ext`` (+ any pre-built
    ``extra_slices`` sharing the same compression header — multi-slice containers).
    Landmarks: one byte offset per SLICE HEADER within the container body (spec §9;
    htslib derives the slice count from the landmark count)."""
    bio = _io.BytesIO()
    write_block(bio, M_RAW, CT_COMPRESSION_HEADER, 0,
                _compression_header_blob(mapped, multiref))
    landmarks = [bio.tell()]
    blob, n_blocks = _slice_blob(ext, n_rec, ref_id, start, span, counter, method,
                                 rans_order, md5=ref_md5)
    bio.write(blob)
    total_rec, total_blocks = n_rec, 1 + n_blocks
    for s_blob, s_blocks, s_rec in extra_slices:
        landmarks.append(bio.tell())
        bio.write(s_blob)
        total_blocks += s_blocks
        total_rec += s_rec
    body = bio.getvalue()
    _container(f, body, ref_id, start, span, total_rec, counter, total_blocks,
               landmarks)


def _unmapped_ext(chunk, counter) -> Dict[str, _ExtBuf]:
    ext: Dict[str, _ExtBuf] = {k: _ExtBuf() for k in _W_IDS}
    for i, (seq, qual, flag) in enumerate(chunk):
        ext["BF"].itf8(flag | BAM_FUNMAP)
        if seq is None:
            # sequence-unknown record ('*'): CF bit 3 set, no base/quality series
            ext["CF"].itf8(2 | 8)
            ext["RL"].itf8(0)
        else:
            ext["CF"].itf8(2 | (1 if qual is not None else 0))  # detached (+ quals)
            ext["RL"].itf8(len(seq))
        ext["AP"].itf8(0)
        ext["RN"].raw(f"r{counter + i}".encode() + b"\x00")
        ext["MF"].itf8(0)
        ext["NS"].itf8(-1)
        ext["NP"].itf8(0)
        ext["TS"].itf8(0)
        ext["TL"].itf8(0)
        if seq is not None:
            for ch_ in seq:
                ext["BA"].byte(ord(ch_))
            if qual is not None:
                ext["QS"].raw(bytes(qual))
    return ext


def _core_compression_header_blob(bf_bits, cf_alpha, cf_lens, rl_bits) -> bytes:
    """Compression header for the core-block-heavy unmapped profile: BF/RL as
    BETA bit fields, CF as real canonical-Huffman codes in the CORE block,
    constant series as zero-bit Huffman — exercises the reader's bit-stream
    lane end to end (the external profile never touches it)."""
    pres = bytearray()
    entries = [(b"RN", bytes([1])), (b"AP", bytes([0])), (b"RR", bytes([0])),
               (b"SM", bytes([0x1B] * 5)), (b"TD", itf8_encode(1) + b"\x00")]
    pres += itf8_encode(len(entries))
    for k, v in entries:
        pres += k + v

    const = {"AP": 0, "MF": 0, "NS": -1, "NP": 0, "TS": 0, "TL": 0}
    encs: List[Tuple[bytes, bytes]] = [
        (b"BF", _enc_beta(0, bf_bits)),
        (b"CF", _enc_huffman(cf_alpha, cf_lens)),
        (b"RL", _enc_beta(0, rl_bits)),
    ]
    for key, v in const.items():
        encs.append((key.encode(), _enc_huffman([v], [0])))
    encs.append((b"BA", _enc_external(_W_IDS["BA"])))
    encs.append((b"QS", _enc_external(_W_IDS["QS"])))
    encs.append((b"RN", _enc_byte_array_stop(0, _W_IDS["RN"])))
    series = bytearray(itf8_encode(len(encs)))
    for k, e in encs:
        series += k + e

    tags = itf8_encode(0)
    out = bytearray()
    for part in (bytes(pres), bytes(series), bytes(tags)):
        out += itf8_encode(len(part)) + part
    return bytes(out)


def _write_unmapped_container_core(f, chunk, counter, method, rans_order):
    """One unmapped container in the core profile (see
    _core_compression_header_blob). Core bits are written in the decoder's
    per-record consumption order: BF, CF, RL (every other core-coded series is
    a zero-bit constant)."""
    bfs, cfs, rls = [], [], []
    for seq, qual, flag in chunk:
        bfs.append(flag | BAM_FUNMAP)
        if seq is None:
            cfs.append(2 | 8)
            rls.append(0)
        else:
            cfs.append(2 | (1 if qual is not None else 0))
            rls.append(len(seq))
    bf_bits = max(max(bfs).bit_length(), 1)
    rl_bits = max(max(rls).bit_length(), 1)
    cf_alpha, cf_lens, cf_codes, cf_len = _huffman_codes(cfs)

    core = _BitWriter()
    ext: Dict[str, _ExtBuf] = {k: _ExtBuf() for k in _W_IDS}
    for i, (seq, qual, flag) in enumerate(chunk):
        core.write_bits(bfs[i], bf_bits)
        core.write_bits(cf_codes[cfs[i]], cf_len)
        core.write_bits(rls[i], rl_bits)
        ext["RN"].raw(f"r{counter + i}".encode() + b"\x00")
        if seq is not None:
            for ch_ in seq:
                ext["BA"].byte(ord(ch_))
            if qual is not None:
                ext["QS"].raw(bytes(qual))

    bio = _io.BytesIO()
    write_block(bio, M_RAW, CT_COMPRESSION_HEADER, 0,
                _core_compression_header_blob(bf_bits, cf_alpha, cf_lens, rl_bits))
    landmarks = [bio.tell()]
    blob, n_blocks = _slice_blob(ext, len(chunk), -1, 0, 0, counter, method,
                                 rans_order, core=core.getvalue())
    bio.write(blob)
    _container(f, bio.getvalue(), -1, 0, 0, len(chunk), counter,
               1 + n_blocks, landmarks)


def _write_unmapped_container(f, chunks, counter, method, rans_order):
    """One container holding one slice per chunk (multi-slice when len(chunks) > 1)."""
    first, rest = chunks[0], chunks[1:]
    ext0 = _unmapped_ext(first, counter)
    c = counter + len(first)
    extras = []
    for ch in rest:
        blob, n_blocks = _slice_blob(_unmapped_ext(ch, c), len(ch), -1, 0, 0, c,
                                     method, rans_order)
        extras.append((blob, n_blocks, len(ch)))
        c += len(ch)
    _write_series_blocks(f, ext0, len(first), -1, 0, 0, counter, method,
                         rans_order, mapped=False, extra_slices=extras)


def _write_mapped_container(f, chunk, reference, counter, method, rans_order):
    ext: Dict[str, _ExtBuf] = {k: _ExtBuf() for k in _W_IDS}
    recs = [_norm_mapped_rec(r, 2) for r in chunk]
    start = min(p for _, p, _f, _q in recs)
    end = max(p + len(s) - 1 for s, p, _f, _q in recs)
    for i, (seq, pos1, flag, qual) in enumerate(recs):
        _mapped_record_series(ext, seq, pos1, flag, qual, reference,
                              f"m{counter + i}".encode())
    span_md5 = hashlib.md5(
        reference[start - 1 : end].encode("ascii", "replace")).digest()
    _write_series_blocks(f, ext, len(chunk), 0, start, end - start + 1, counter,
                         method, rans_order, mapped=True, ref_md5=span_md5)
