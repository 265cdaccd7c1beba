"""fqzcomp quality codec (CRAM 3.1 block compression method 7).

CRAM 3.1's archive profile compresses quality-score blocks with fqzcomp (the
"FQZComp quality codec" section of the hts-specs CRAMcodecs document): an
adaptive context-mixing model over the range-coder substrate of
io/range_coder.py. Each quality is coded under a context built from the
quantized previous qualities, the position within the record, and a running
"delta" count of how unstable the recent qualities were — the structure that
makes Illumina quality strings (long smooth runs with burst errors) compress
2-4x better than order-1 byte coding. Record lengths are coded in-stream (the
spec's do_len feature), so a block decodes with no side channel, and identical
consecutive quality strings collapse to one dedup bit (do_dedup).

Clean-room from the specification, with the same honesty note as io/tok3.py:
the spec's exact parameter-block bit layout could not be cross-checked against
any upstream stream in this environment, so this is a spec-SHAPED container —
same context model (q1/q2 history, position, delta), same range-coder
substrate, same in-stream lengths and dedup — whose bytes are self-consistent
rather than verified-interoperable. Malformed input raises ValueError, which
the CRAM reader surfaces as UnsupportedCodecError: LOUD for quality blocks
(quals feed the engine's base-quality filter; SPEC_SEMANTICS §4), droppable
only for the name series. Reference dependency set:
/root/reference/.github/workflows/ci.yml:24-25.

Layout (decode order):

    vers:u8   (5, the codec's format version)
    gflags:u8 (0x01 do_dedup; other bits reserved, rejected)
    nsym:u8   (count of DISTINCT quality values; models are sized to it)
    qmap[nsym]:u8  (dense index -> quality value, the spec's qmap: models and
                    contexts run over dense indices so 4-level binned quals get
                    4-symbol models, not 40-symbol ones)
    qbits:u8 q2bits:u8 pbits:u8 dbits:u8  (context geometry, sum <= 16)
    ulen:uint7  (total quality bytes)
    ucrc:u32le  (crc32 of the uncompressed bytes: decode is all-or-nothing —
                 a truncated/corrupt stream can never return wrong quals)
    range-coded stream:
      per record: len as 4 bytes (LEN0..LEN3 models, little-endian);
      if do_dedup and len == previous len: 1 dup bit (copy previous record);
      else one dense index per base under ctx(q1, q2, pos, delta).

Throughput note: this is the normative pure-Python codec (~1 MB/s) — fqzcomp
blocks are an archive-read path, not the hot feeder path (the writer defaults
to rANS Nx16, whose decode is native C++; io/native.py).

The port's copy of ``denovo_kmer_tpu/io/fqz.py``; its imports point at the port.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from denovo_kmer_tpu_torch.io.range_coder import RangeDecoder, RangeEncoder, SimpleModel
from denovo_kmer_tpu_torch.io.rans_nx16 import uint7_decode, uint7_encode

_VERS = 5
G_DEDUP = 0x01

# context geometry defaults: 6+2+5+3 = 16 bits of context
_QBITS, _Q2BITS, _PBITS, _DBITS = 6, 2, 5, 3


class _Ctx:
    """Shared encoder/decoder model state; both sides must replay identically
    (the adaptive models' bubble reordering is part of the coded state)."""

    __slots__ = ("max_sym", "qbits", "q2bits", "pbits", "dbits", "qual",
                 "lens", "dup")

    def __init__(self, max_sym: int, qbits: int, q2bits: int, pbits: int,
                 dbits: int) -> None:
        self.max_sym = max_sym
        self.qbits = qbits
        self.q2bits = q2bits
        self.pbits = pbits
        self.dbits = dbits
        self.qual: Dict[int, SimpleModel] = {}
        self.lens = [SimpleModel(256) for _ in range(4)]
        self.dup = SimpleModel(2)

    def qual_model(self, ctx: int) -> SimpleModel:
        m = self.qual.get(ctx)
        if m is None:
            m = self.qual[ctx] = SimpleModel(self.max_sym)
        return m

    def ctx_of(self, q1: int, q2: int, pos: int, delta: int) -> int:
        # q2 enters as a TREND (same/down/up vs q1): raw high quals are nearly
        # constant, but the local direction is what predicts the next symbol
        trend = 0 if q2 == q1 else (1 if q2 < q1 else 2)
        # nonuniform position bucket: exact for the first half of the bucket
        # space, 8-position-coarse after (read tails degrade slowly)
        half = 1 << (self.pbits - 1)
        p = pos if pos < half else half + min((pos - half) >> 3, half - 1)
        c = min(q1, (1 << self.qbits) - 1)
        c = (c << self.q2bits) | min(trend, (1 << self.q2bits) - 1)
        c = (c << self.pbits) | p
        return (c << self.dbits) | min(delta, (1 << self.dbits) - 1)


# ------------------------------------------------------------------ encode

# geometry candidates the encoder races on a sample (decode is header-driven, so
# any (qbits, q2bits, pbits, dbits) with pbits >= 1 and sum <= 16 decodes): the
# full context, delta off (iid-per-position data), and a plain order-1 analog.
_GEOMETRIES = ((_QBITS, _Q2BITS, _PBITS, _DBITS), (6, 2, 5, 0), (6, 0, 1, 0))
_SAMPLE_BYTES = 1 << 15


def _encode_stream(data: bytes, lens: Sequence[int], to_idx: Dict[int, int],
                   nsym: int, geom: Tuple[int, int, int, int],
                   dedup: bool) -> bytes:
    st = _Ctx(nsym, *geom)
    rc = RangeEncoder()
    off = 0
    prev: Optional[bytes] = None
    for ln in lens:
        rec = data[off:off + ln]
        off += ln
        for i in range(4):
            st.lens[i].encode(rc, (ln >> (8 * i)) & 0xFF)
        if dedup and prev is not None and ln == len(prev):
            is_dup = rec == prev
            st.dup.encode(rc, int(is_dup))
            if is_dup:
                prev = rec
                continue
        q1 = q2 = delta = 0
        for pos, q in enumerate(rec):
            qi = to_idx[q]
            st.qual_model(st.ctx_of(q1, q2, pos, delta)).encode(rc, qi)
            if qi != q1:
                delta += 1
            q2 = q1
            q1 = qi
        prev = rec
    return rc.finish()


def encode(data: bytes, lens: Optional[Sequence[int]] = None,
           dedup: bool = True) -> bytes:
    """Encode one quality block. ``lens`` gives the per-record quality-string
    lengths (the CRAM writer passes the slice's RL values); ``None`` treats the
    block as a single record."""
    if lens is None:
        lens = [len(data)] if data else []
    if sum(lens) != len(data):
        raise ValueError(f"fqz: record lengths sum to {sum(lens)}, "
                         f"block is {len(data)} bytes")
    qmap = sorted(set(data)) if data else [0]
    to_idx = {q: i for i, q in enumerate(qmap)}

    geom = _GEOMETRIES[0]
    if len(data) > 2 * _SAMPLE_BYTES:
        # race the candidate context geometries on a prefix sample
        s_lens: List[int] = []
        tot = 0
        for ln in lens:
            if tot >= _SAMPLE_BYTES:
                break
            s_lens.append(ln)
            tot += ln
        sample = data[:tot]
        geom = min(_GEOMETRIES, key=lambda g: len(
            _encode_stream(sample, s_lens, to_idx, len(qmap), g, dedup)))

    out = bytearray()
    out.append(_VERS)
    out.append(G_DEDUP if dedup else 0)
    out.append(len(qmap) & 0xFF)
    out += bytes(qmap)
    out += bytes(geom)
    out += uint7_encode(len(data))
    out += struct.pack("<I", zlib.crc32(data))
    if lens:
        out += _encode_stream(data, lens, to_idx, len(qmap), geom, dedup)
    return bytes(out)


# ------------------------------------------------------------------ decode

def decode(data: bytes, expected_len: Optional[int] = None) -> bytes:
    """Decode one fqzcomp quality block back to concatenated quality bytes.
    Raises ValueError on any structural inconsistency (the CRAM reader maps
    that to UnsupportedCodecError — loud when the block feeds the QS series)."""
    if len(data) < 12:
        raise ValueError("fqz: truncated header")
    if data[0] != _VERS:
        raise ValueError(f"fqz: unknown version {data[0]}")
    gflags = data[1]
    if gflags & ~G_DEDUP:
        raise ValueError(f"fqz: unknown flags 0x{gflags:02x}")
    nsym = data[2]
    if nsym == 0:
        raise ValueError("fqz: zero symbol count")
    qmap = data[3:3 + nsym]
    if len(qmap) != nsym:
        raise ValueError("fqz: truncated qmap")
    pos = 3 + nsym
    if pos + 4 > len(data):
        raise ValueError("fqz: truncated header")
    qbits, q2bits, pbits, dbits = data[pos:pos + 4]
    pos += 4
    if qbits + q2bits + pbits + dbits > 16 or pbits < 1:
        raise ValueError("fqz: bad context geometry")
    ulen, pos = uint7_decode(data, pos)
    if expected_len is not None and ulen != expected_len:
        raise ValueError(f"fqz: header length {ulen} != block length {expected_len}")
    if pos + 4 > len(data):
        raise ValueError("fqz: truncated checksum")
    (ucrc,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if ulen == 0:
        if ucrc != 0:
            raise ValueError("fqz: checksum mismatch on empty block")
        return b""
    if pos + 6 > len(data):
        raise ValueError("fqz: payload shorter than the range-coder prime")

    dedup = bool(gflags & G_DEDUP)

    # native record loop when the shim is built (io/_native/arith_codec.cpp);
    # the Python loop below stays the normative reference (~100x slower)
    try:
        from denovo_kmer_tpu_torch.io.native import fqz_decode_native

        res = fqz_decode_native(bytes(data), pos, bytes(qmap),
                                (qbits, q2bits, pbits, dbits), dedup, ulen)
    except ImportError:  # pragma: no cover - shim loader missing entirely
        res = None
    if res is not None:
        if zlib.crc32(res) != ucrc:
            raise ValueError("fqz: checksum mismatch (corrupt or foreign stream)")
        return res

    st = _Ctx(nsym, qbits, q2bits, pbits, dbits)
    rc = RangeDecoder(data, pos)
    out = bytearray()
    prev: Optional[bytes] = None
    while len(out) < ulen:
        if rc.pos > len(data) + 8:
            # consuming the decoder's zero-fill: a well-formed stream's 5-byte
            # tail flush keeps real payload inside the buffer
            raise ValueError("fqz: stream exhausted before block was rebuilt")
        ln = 0
        for i in range(4):
            ln |= st.lens[i].decode(rc) << (8 * i)
        if len(out) + ln > ulen:
            raise ValueError(f"fqz: record of {ln} bytes overruns block "
                             f"({len(out) + ln} > {ulen})")
        if dedup and prev is not None and ln == len(prev):
            if st.dup.decode(rc):
                out += prev
                continue
        rec = bytearray()
        q1 = q2 = delta = 0
        for p in range(ln):
            qi = st.qual_model(st.ctx_of(q1, q2, p, delta)).decode(rc)
            rec.append(qmap[qi])
            if qi != q1:
                delta += 1
            q2 = q1
            q1 = qi
        out += rec
        prev = bytes(rec)
    if len(out) != ulen:
        raise ValueError(f"fqz: reconstructed {len(out)} bytes, want {ulen}")
    if zlib.crc32(bytes(out)) != ucrc:
        raise ValueError("fqz: checksum mismatch (corrupt or foreign stream)")
    return bytes(out)
