"""Adaptive arithmetic codec (CRAM 3.1 block compression method 6).

CRAM 3.1's archive profile compresses data series with an adaptive range coder
(the "Adaptive arithmetic coding" section of the hts-specs CRAMcodecs document):
order-0 or order-1 byte models over the carry-counting range coder in
io/range_coder.py, plus the same reversible pre-transforms as rANS Nx16 —
bit-PACK and STRIPE (shared helpers from io/rans_nx16.py) — and two of its own:
an entropy-integrated RLE (runs are coded inline with dedicated run models, not
via a separate meta stream like Nx16's RLE) and EXT (the payload is handed to a
general-purpose external codec, bzip2, instead of the range coder).

Clean-room from the specification; same interop caveat as io/rans_nx16.py — no
htslib/htscodecs binary exists in this environment, so conformance is validated
by spec-derived structure, exhaustive roundtrips, and differential tests only.
Reference dependency set: /root/reference/.github/workflows/ci.yml:24-25.

Layout summary (decode order):

    flags:u8
      0x01 ORDER1   order-1 (context = previous byte) instead of order-0
      0x04 EXT      payload bzip2-compressed instead of range-coded
      0x08 STRIPE   X byte-interleaved sub-streams, each its own arith stream
      0x10 NOSZ     uncompressed size omitted (caller supplies it; STRIPE subs)
      0x20 CAT      payload stored raw
      0x40 RLE      runs coded inline: literal model + run-length models
      0x80 PACK     bit-packing pre-transform (shared with rANS Nx16)
    [ulen:uint7 unless NOSZ]
    STRIPE: N:u8, clen[N]:uint7, then N complete sub-streams
    else:   [PACK meta] payload (range-coded | EXT bzip2 | CAT raw)

Run-length integration (RLE set, CAT/EXT clear): each literal is coded with the
byte model (order-0: one model; order-1: per-previous-literal models), then its
extra-repeat count in base-255 chunks — the first chunk's model is indexed by
the literal value, continuation chunks use models 256 then 257, a chunk of 255
means "more follows".

The port's copy of ``denovo_kmer_tpu/io/arith.py``; its imports point at the port.
"""

from __future__ import annotations

import bz2
from typing import Optional

from denovo_kmer_tpu_torch.io.range_coder import RangeDecoder, RangeEncoder, SimpleModel
from denovo_kmer_tpu_torch.io.rans_nx16 import (
    _pack_decode,
    _pack_decode_meta,
    _pack_encode,
    uint7_decode,
    uint7_encode,
)

F_ORDER1 = 0x01
F_EXT = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80


# ------------------------------------------------------------------ entropy cores

def _encode_entropy(data: bytes, order: int, rle: bool) -> bytes:
    rc = RangeEncoder()
    if order:
        lit = [None] * 256

        def lit_model(c: int) -> SimpleModel:
            m = lit[c]
            if m is None:
                m = lit[c] = SimpleModel(256)
            return m
    else:
        lit0 = SimpleModel(256)

        def lit_model(c: int) -> SimpleModel:
            return lit0

    if not rle:
        prev = 0
        for b in data:
            lit_model(prev).encode(rc, b)
            prev = b if order else 0
        return rc.finish()

    run_models = [None] * 258

    def run_model(i: int) -> SimpleModel:
        m = run_models[i]
        if m is None:
            m = run_models[i] = SimpleModel(256)
        return m

    n = len(data)
    i = 0
    prev = 0
    while i < n:
        b = data[i]
        j = i + 1
        while j < n and data[j] == b:
            j += 1
        lit_model(prev).encode(rc, b)
        prev = b if order else 0
        r = j - i - 1
        ctx = b
        while True:
            chunk = min(r, 255)
            run_model(ctx).encode(rc, chunk)
            r -= chunk
            if chunk < 255:
                break
            ctx = 256 if ctx == b else 257
        i = j
    return rc.finish()


def _decode_entropy(buf, pos: int, out_len: int, order: int, rle: bool) -> bytes:
    # native hot loop when the shim is built (io/_native/arith_codec.cpp — the
    # Python model loop below stays the normative reference, ~800x slower);
    # import kept lazy and failure-tolerant: decode must work from a bare checkout
    try:
        from denovo_kmer_tpu_torch.io.native import arith_entropy_decode_native

        res = arith_entropy_decode_native(
            bytes(buf), pos, out_len, bool(order), bool(rle))
        if res is not None:
            return res
    except ImportError:  # pragma: no cover - shim loader missing entirely
        pass
    return _decode_entropy_py(buf, pos, out_len, order, rle)


def _decode_entropy_py(buf, pos: int, out_len: int, order: int, rle: bool) -> bytes:
    rc = RangeDecoder(buf, pos)
    if order:
        lit = [None] * 256

        def lit_model(c: int) -> SimpleModel:
            m = lit[c]
            if m is None:
                m = lit[c] = SimpleModel(256)
            return m
    else:
        lit0 = SimpleModel(256)

        def lit_model(c: int) -> SimpleModel:
            return lit0

    out = bytearray()
    prev = 0
    if not rle:
        for _ in range(out_len):
            b = lit_model(prev).decode(rc)
            out.append(b)
            prev = b if order else 0
        return bytes(out)

    run_models = [None] * 258

    def run_model(i: int) -> SimpleModel:
        m = run_models[i]
        if m is None:
            m = run_models[i] = SimpleModel(256)
        return m

    while len(out) < out_len:
        b = lit_model(prev).decode(rc)
        prev = b if order else 0
        r = 0
        ctx = b
        while True:
            chunk = run_model(ctx).decode(rc)
            r += chunk
            if chunk < 255:
                break
            ctx = 256 if ctx == b else 257
        out += bytes([b]) * (r + 1)
    if len(out) != out_len:
        raise ValueError(f"arith: RLE run overran output ({len(out)} > {out_len})")
    return bytes(out)


# ------------------------------------------------------------------ public API

def encode(data: bytes, order: int = 0, use_pack: bool = False,
           use_rle: bool = False, stripe: int = 0, nosz: bool = False,
           ext: bool = False) -> bytes:
    """Encode with explicit flags (the CRAM writer picks; tests sweep combinations)."""
    out = bytearray()
    if len(data) == 0 and not stripe:
        out.append(F_CAT | (F_NOSZ if nosz else 0))
        if not nosz:
            out += uint7_encode(0)
        return bytes(out)
    if stripe:
        flags = F_STRIPE | (F_NOSZ if nosz else 0)
        out.append(flags)
        if not nosz:
            out += uint7_encode(len(data))
        X = stripe
        out.append(X)
        subs = [encode(data[j::X], order=order, use_pack=use_pack,
                       use_rle=use_rle, nosz=True, ext=ext) for j in range(X)]
        for s in subs:
            out += uint7_encode(len(s))
        for s in subs:
            out += s
        return bytes(out)

    flags = F_ORDER1 if order == 1 else 0
    payload = data
    pack_meta = None
    if use_pack:
        p = _pack_encode(payload)
        if p is not None:
            flags |= F_PACK
            pack_meta, payload = p
    if nosz:
        flags |= F_NOSZ
    if ext:
        flags |= F_EXT
    elif use_rle:
        flags |= F_RLE
    # tiny payloads: CAT beats adaptive coding and its 6-byte floor
    if len(payload) < 8 and not (flags & (F_PACK | F_EXT)):
        out.append((flags & ~F_RLE) | F_CAT)
        if not nosz:
            out += uint7_encode(len(data))
        out += payload
        return bytes(out)
    out.append(flags)
    if not nosz:
        out += uint7_encode(len(data))
    if flags & F_PACK:
        out += pack_meta
    if flags & F_EXT:
        out += bz2.compress(payload, 9)
    else:
        out += _encode_entropy(payload, order, bool(flags & F_RLE))
    return bytes(out)


def decode(data: bytes, expected_len: Optional[int] = None) -> bytes:
    """Decode one complete adaptive-arithmetic stream. ``expected_len`` is
    required when the stream was written with NOSZ."""
    buf = data
    pos = 0
    flags = buf[pos]
    pos += 1
    if flags & F_NOSZ:
        if expected_len is None:
            raise ValueError("arith: NOSZ stream needs an external length")
        ulen = expected_len
    else:
        ulen, pos = uint7_decode(buf, pos)
    if flags & F_STRIPE:
        import numpy as np

        X = buf[pos]
        pos += 1
        clens = []
        for _ in range(X):
            c, pos = uint7_decode(buf, pos)
            clens.append(c)
        out = np.zeros(ulen, np.uint8)
        for j in range(X):
            sub_len = (ulen - j + X - 1) // X
            sub = decode(buf[pos:pos + clens[j]], expected_len=sub_len)
            pos += clens[j]
            out[j::X] = np.frombuffer(sub, np.uint8)
        return out.tobytes()

    pack_syms = None
    cur_len = ulen
    if flags & F_PACK:
        pack_syms, plen, pos = _pack_decode_meta(buf, pos)
        cur_len = plen
    if flags & F_CAT:
        payload = bytes(buf[pos:pos + cur_len])
        if len(payload) != cur_len:
            raise ValueError("arith: CAT payload truncated")
    elif flags & F_EXT:
        payload = bz2.decompress(bytes(buf[pos:]))
        if len(payload) != cur_len:
            raise ValueError(
                f"arith: EXT payload is {len(payload)} bytes, want {cur_len}")
    else:
        payload = _decode_entropy(buf, pos, cur_len,
                                  flags & F_ORDER1, bool(flags & F_RLE))
    if flags & F_PACK:
        payload = _pack_decode(payload, pack_syms, ulen)
    if len(payload) != ulen:
        raise ValueError(f"arith: decoded {len(payload)} bytes, want {ulen}")
    return payload
