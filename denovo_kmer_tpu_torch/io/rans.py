"""rANS 4x8 codec (CRAM 3.0 block compression method 4) — pure-Python encoder/decoder.

Implements the rANS_static "4x8" variant the CRAM 3.0 spec mandates (order-0 and order-1),
following the spec §13 / htscodecs rANS_static.c conventions (the reference reads CRAM
through exactly this codec via HTSlib — SURVEY.md §2.1 C3):

- 4 interleaved 32-bit rANS states, lower bound L = 1<<23, byte-wise renormalization
- 12-bit frequencies (total 4096) with the spec's RLE'd frequency-table serialization
- order-0 interleaves states over positions (state = i & 3)
- order-1 splits the payload into 4 quarters (floor split; the 4th quarter absorbs the
  remainder), one state per quarter, each byte conditioned on its predecessor in-quarter

Host-side decode speed is secondary (CRAM blocks are bounded and the C++ shim can take this
over later); correctness and byte-format fidelity are what the tests pin down.

The port's copy of ``denovo_kmer_tpu/io/rans.py``; its imports point at the port.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT  # 4096
RANS_L = 1 << 23


# ---------------------------------------------------------------------------
# frequency normalization + table (de)serialization
# ---------------------------------------------------------------------------

def _normalize_freqs(hist: List[int], total: int = TOTFREQ) -> List[int]:
    """Scale a histogram so it sums to ``total``, keeping every nonzero symbol >= 1."""
    n = sum(hist)
    if n == 0:
        return [0] * 256
    out = [0] * 256
    acc = []
    for s, f in enumerate(hist):
        if f:
            scaled = f * total / n
            base = max(int(scaled), 1)
            acc.append((scaled - base, s, base))
            out[s] = base
    diff = total - sum(out)
    if diff > 0:
        acc.sort(reverse=True)
        i = 0
        while diff > 0:
            out[acc[i % len(acc)][1]] += 1
            i += 1
            diff -= 1
    elif diff < 0:
        for _ in range(-diff):
            s = max(range(256), key=lambda x: out[x])
            assert out[s] > 1, "cannot normalize: too many distinct symbols"
            out[s] -= 1
    assert sum(out) == total
    return out



def _write_rle_keys(present, emit_payload) -> bytearray:
    """Serialize an ascending key list with the spec's RLE (run byte after a key that
    directly follows its predecessor), calling ``emit_payload(out, key)`` per key; shared
    by the order-0 symbol table and the order-1 context table."""
    out = bytearray()
    rle = 0
    last = -2
    present = sorted(present)
    pset = set(present)
    for j in present:
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j == last + 1:
                run = 0
                while j + run + 1 < 256 and (j + run + 1) in pset:
                    run += 1
                out.append(run)
                rle = run
        emit_payload(out, j)
        last = j
    out.append(0)
    return out


def _read_rle_keys(buf: bytes, pos: int, read_payload) -> int:
    """Mirror of ``_write_rle_keys``: ``read_payload(key, pos) -> pos`` consumes each
    key's payload. Returns the position after the 0 terminator."""
    sym = buf[pos]
    pos += 1
    last = -2
    rle = 0
    explicit = True
    while True:
        if explicit and last >= 0 and sym == last + 1:
            rle = buf[pos]
            pos += 1
        pos = read_payload(sym, pos)
        last = sym
        if rle:
            rle -= 1
            sym = last + 1
            explicit = False
        else:
            sym = buf[pos]
            pos += 1
            explicit = True
            if sym == 0:
                break
    return pos

def _write_freqs(freqs: List[int]) -> bytes:
    """Spec §13 frequency-table serialization (RLE'd keys + 1-2 byte frequencies)."""

    def emit(out, j):
        f = freqs[j]
        if f < 128:
            out.append(f)
        else:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)

    return bytes(_write_rle_keys([j for j in range(256) if freqs[j]], emit))


def _read_freqs(buf: bytes, pos: int) -> Tuple[List[int], int]:
    """Mirror of ``_write_freqs``."""
    freqs = [0] * 256

    def take(sym, pos):
        f = buf[pos]
        pos += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | buf[pos]
            pos += 1
        freqs[sym] = f
        return pos

    pos = _read_rle_keys(buf, pos, take)
    return freqs, pos


def _cumulative(freqs: List[int]) -> Tuple[List[int], bytes]:
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    lut = bytearray(TOTFREQ)
    for s in range(256):
        for i in range(cum[s], cum[s + 1]):
            lut[i] = s
    return cum, bytes(lut)


def _put(states_R: int, f: int, cum_s: int, out_rev: bytearray) -> int:
    x_max = ((RANS_L >> TF_SHIFT) << 8) * f
    R = states_R
    while R >= x_max:
        out_rev.append(R & 0xFF)
        R >>= 8
    return ((R // f) << TF_SHIFT) + (R % f) + cum_s


# ---------------------------------------------------------------------------
# order-0
# ---------------------------------------------------------------------------

def encode_o0(data: bytes) -> bytes:
    """rANS 4x8 order-0 encode. Returns the full payload incl. the 9-byte header
    (order, compressed size, raw size)."""
    n = len(data)
    hist = [0] * 256
    for b in data:
        hist[b] += 1
    freqs = _normalize_freqs(hist)
    cum, _ = _cumulative(freqs)

    states = [RANS_L] * 4
    out_rev = bytearray()
    for i in range(n - 1, -1, -1):
        s = data[i]
        states[i & 3] = _put(states[i & 3], freqs[s], cum[s], out_rev)
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    comp = _write_freqs(freqs) + head + bytes(reversed(out_rev))
    return struct.pack("<BII", 0, len(comp), n) + comp


def decode_o0(payload: bytes) -> bytes:
    order, _comp, raw_size = struct.unpack_from("<BII", payload, 0)
    assert order == 0, f"not an order-0 rANS block (order={order})"
    if raw_size == 0:
        return b""
    pos = 9
    freqs, pos = _read_freqs(payload, pos)
    cum, lut = _cumulative(freqs)
    states = list(struct.unpack_from("<4I", payload, pos))
    pos += 16
    out = bytearray(raw_size)
    mask = TOTFREQ - 1
    for i in range(raw_size):
        j = i & 3
        R = states[j]
        slot = R & mask
        s = lut[slot]
        out[i] = s
        R = freqs[s] * (R >> TF_SHIFT) + slot - cum[s]
        while R < RANS_L and pos < len(payload):
            R = (R << 8) | payload[pos]
            pos += 1
        states[j] = R
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1
# ---------------------------------------------------------------------------

def _o1_segments(n: int) -> List[Tuple[int, int]]:
    """Floor quarters; the 4th segment absorbs the remainder (htscodecs layout)."""
    q = n >> 2
    return [(0, q), (q, 2 * q), (2 * q, 3 * q), (3 * q, n)]


def encode_o1(data: bytes) -> bytes:
    n = len(data)
    segs = [data[a:b] for a, b in _o1_segments(n)]
    hist: Dict[int, List[int]] = {}
    for seg in segs:
        last = 0
        for b in seg:
            hist.setdefault(last, [0] * 256)[b] += 1
            last = b
    freqs = {ctx: _normalize_freqs(h) for ctx, h in hist.items()}
    cums = {ctx: _cumulative(f)[0] for ctx, f in freqs.items()}

    states = [RANS_L] * 4
    out_rev = bytearray()
    q = n >> 2
    # reverse of the decode order: decode does rows 0..q-1 over states 0..3, then state 3
    # drains its tail — so encode the tail first (backwards), then rows q-1..0, states 3..0
    tail = segs[3]
    for r in range(len(tail) - 1, q - 1, -1):
        ctx = tail[r - 1] if r > 0 else 0
        s = tail[r]
        states[3] = _put(states[3], freqs[ctx][s], cums[ctx][s], out_rev)
    for r in range(q - 1, -1, -1):
        for k in (3, 2, 1, 0):
            seg = segs[k]
            ctx = seg[r - 1] if r > 0 else 0
            s = seg[r]
            states[k] = _put(states[k], freqs[ctx][s], cums[ctx][s], out_rev)

    # context-major table: same RLE over contexts, nested order-0 tables
    table = _write_rle_keys(
        sorted(freqs), lambda out, ctx: out.extend(_write_freqs(freqs[ctx]))
    )

    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    comp = bytes(table) + head + bytes(reversed(out_rev))
    return struct.pack("<BII", 1, len(comp), n) + comp


def decode_o1(payload: bytes) -> bytes:
    order, _comp, raw_size = struct.unpack_from("<BII", payload, 0)
    assert order == 1, f"not an order-1 rANS block (order={order})"
    if raw_size == 0:
        return b""
    pos = 9
    freqs: Dict[int, List[int]] = {}

    def take_ctx(ctx, p):
        f, p = _read_freqs(payload, p)
        freqs[ctx] = f
        return p

    pos = _read_rle_keys(payload, pos, take_ctx)
    tabs = {c: _cumulative(f) for c, f in freqs.items()}

    states = list(struct.unpack_from("<4I", payload, pos))
    pos += 16
    n = raw_size
    bounds = _o1_segments(n)
    q = n >> 2
    out = bytearray(n)
    lasts = [0, 0, 0, 0]
    mask = TOTFREQ - 1

    def step(k: int, at: int):
        nonlocal pos
        c = lasts[k]
        cum, lut = tabs[c]
        fr = freqs[c]
        R = states[k]
        slot = R & mask
        s = lut[slot]
        out[at] = s
        R = fr[s] * (R >> TF_SHIFT) + slot - cum[s]
        while R < RANS_L and pos < len(payload):
            R = (R << 8) | payload[pos]
            pos += 1
        states[k] = R
        lasts[k] = s

    for r in range(q):
        for k in range(4):
            step(k, bounds[k][0] + r)
    for at in range(bounds[3][0] + q, n):
        step(3, at)
    return bytes(out)


def decode(payload: bytes) -> bytes:
    """Dispatch on the order byte (CRAM block method 4 payload). Uses the C++ shim's
    decoder when built (io/_native/rans_codec.cpp, ~100x the pure-Python rate;
    differential-tested against this module in tests/test_native_rans.py), falling
    back to the normative Python implementation."""
    order = payload[0]
    if order not in (0, 1):
        raise ValueError(f"unknown rANS order {order}")
    import os

    if not os.environ.get("DENOVO_KMER_NO_NATIVE_RANS"):
        from denovo_kmer_tpu_torch.io.native import rans_decode_native

        raw_size = struct.unpack_from("<I", payload, 5)[0] if len(payload) >= 9 else 0
        got = rans_decode_native(payload, raw_size, nx16=False)
        if got is not None:
            return got
    if order == 0:
        return decode_o0(payload)
    return decode_o1(payload)


def encode(data: bytes, order: int = 0) -> bytes:
    if len(data) == 0:
        return struct.pack("<BII", 0, 0, 0)
    return encode_o0(data) if order == 0 else encode_o1(data)
