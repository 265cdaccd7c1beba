"""rANS Nx16 codec (CRAM 3.1 block compression method 5).

CRAM 3.1 (the current htslib output format; reference dependency set `ci.yml:24-25`
implies the full htslib CRAM stack) introduces the rANS Nx16 entropy coder: N-way
(4 or 32) interleaved range-ANS states with 16-bit renormalization and 12-bit (order-0)
or 12/10-bit (order-1) frequencies, plus three reversible pre-transforms — bit-PACK,
RLE, and STRIPE — selected by a leading format-flags byte.

This is a clean-room implementation from the public CRAM 3.1 codecs specification
("CRAM compression: rANS Nx16" section of the hts-specs CRAMcodecs document); both
directions are implemented so the suite can roundtrip every flag combination and the
CRAM writer can emit 3.1 fixtures. CAVEAT, stated plainly: no htslib/htscodecs binary
is available in this build environment, so cross-validation against upstream-encoded
streams is limited to the spec-derived fixtures in tests/test_rans_nx16.py; interop
with foreign encoders should be re-verified when tooling is available (same posture as
the round-2 rANS 4x8 / CRAM 3.0 work).

Layout summary (decode order):

    flags:u8
      0x01 ORDER1   order-1 (context = previous byte) instead of order-0
      0x04 N32      32 interleaved states instead of 4
      0x08 STRIPE   X byte-interleaved sub-streams, each its own ransNx16 stream
      0x10 NOSZ     uncompressed size omitted (caller supplies it; used by STRIPE subs)
      0x20 CAT      payload stored raw
      0x40 RLE      run-length pre-transform (meta: run symbols + uint7 run lengths)
      0x80 PACK     bit-packing pre-transform (1/2/4 bits per symbol, <=16 symbols)
    [ulen:uint7 unless NOSZ]
    STRIPE: N:u8, clen[N]:uint7, then N complete sub-streams
    else:   [PACK meta] [RLE meta] entropy-coded payload

Transforms compose encode-side as pack -> rle -> rans; decode reverses.

The port's copy of ``denovo_kmer_tpu/io/rans_nx16.py``; its imports point at the port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

F_ORDER1 = 0x01
F_N32 = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80

_L = 1 << 15  # lower bound of the rANS state interval
_TF_SHIFT_O0 = 12


# ---------------------------------------------------------------- varint + alphabet

def uint7_encode(v: int) -> bytes:
    """Big-endian base-128 varint (ReadUint7 in the spec)."""
    if v < 0:
        raise ValueError("uint7 must be non-negative")
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def uint7_decode(buf, pos: int) -> Tuple[int, int]:
    v = 0
    while True:
        b = buf[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, pos


def _encode_alphabet(syms: List[int]) -> bytes:
    """Ascending symbol list with consecutive-run compression, 0-terminated (the spec's
    alphabet serialization; 0 may only appear first, so the terminator is unambiguous)."""
    assert syms == sorted(set(syms)) and all(0 <= s < 256 for s in syms)
    out = bytearray([syms[0]])
    last = syms[0]
    i = 1
    while i < len(syms):
        s = syms[i]
        out.append(s)
        if s == last + 1:
            r = 0
            while i + 1 + r < len(syms) and syms[i + 1 + r] == s + 1 + r:
                r += 1
            out.append(r)
            last = s + r
            i += 1 + r
        else:
            last = s
            i += 1
    out.append(0)
    return bytes(out)


def _decode_alphabet(buf, pos: int) -> Tuple[List[int], int]:
    syms: List[int] = []
    rle = 0
    sym = buf[pos]
    pos += 1
    while True:
        syms.append(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            last = sym
            sym = buf[pos]
            pos += 1
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
        if sym == 0:
            return syms, pos
        if sym > 255 or (syms and sym <= syms[-1] and rle == 0 and sym != 0):
            raise ValueError("rans_nx16: corrupt alphabet (non-ascending)")


def _normalize_freqs(counts: np.ndarray, total: int) -> np.ndarray:
    """Scale histogram to sum exactly `total`, every present symbol >= 1."""
    n = counts.sum()
    assert n > 0
    f = np.maximum((counts.astype(np.float64) * total / n).astype(np.int64),
                   (counts > 0).astype(np.int64))
    # fix rounding drift on the most frequent symbol; keep everything >= 1
    drift = total - int(f.sum())
    order = np.argsort(-f)
    i = 0
    while drift != 0:
        s = order[i % len(order)]
        if f[s] > 0 and (drift > 0 or f[s] > 1):
            step = 1 if drift > 0 else -1
            f[s] += step
            drift -= step
        i += 1
    return f


# ---------------------------------------------------------------- order-0 core

def _rans_encode_core(data: bytes, freqs: np.ndarray, cum: np.ndarray, shift: int,
                      N: int, ctx: Optional[bytes] = None,
                      cum2: Optional[np.ndarray] = None,
                      freqs2: Optional[np.ndarray] = None) -> bytes:
    """Shared N-state encoder. Order-0 when ctx is None; order-1 uses per-context
    tables freqs2/cum2 indexed [ctx][sym] with `ctx` the context byte per position."""
    states = [_L] * N
    out = bytearray()
    n = len(data)
    if ctx is None:
        # order-0: state j owns positions j, j+N, ... ; encode in reverse
        for i in range(n - 1, -1, -1):
            j = i % N
            s = data[i]
            f, c = int(freqs[s]), int(cum[s])
            x = states[j]
            x_max = ((_L >> shift) << 16) * f
            while x >= x_max:
                # whole-stream reversal below flips pair order: emit hi, lo -> LE
                out.append((x >> 8) & 0xFF)
                out.append(x & 0xFF)
                x >>= 16
            states[j] = ((x // f) << shift) + (x % f) + c
    else:
        # order-1: fragment k = positions [k*frag, ...); tail handled by state N-1.
        # Encode in reverse per state; renorm bytes interleave in global reverse order.
        frag = n // N
        pos_lists: List[List[int]] = [
            list(range(k * frag, (k + 1) * frag)) for k in range(N)
        ]
        pos_lists[N - 1].extend(range(N * frag, n))
        # walk all positions in reverse global encode order: states are independent,
        # but output bytes must be emitted in a single deterministic order — the spec
        # emits per-state renorm bytes as encountered while looping i = n-1 .. 0 over
        # a round-robin of the interleaved schedule. For fragments, the schedule is:
        # step t emits position t of each fragment, states cycling 0..N-1; reverse it.
        sched: List[Tuple[int, int]] = []  # (state, position)
        max_len = max(len(p) for p in pos_lists)
        for t in range(max_len):
            for k in range(N):
                if t < len(pos_lists[k]):
                    sched.append((k, pos_lists[k][t]))
        for k, i in reversed(sched):
            s = data[i]
            c = ctx[i]
            f = int(freqs2[c][s])
            cm = int(cum2[c][s])
            x = states[k]
            x_max = ((_L >> shift) << 16) * f
            while x >= x_max:
                out.append((x >> 8) & 0xFF)
                out.append(x & 0xFF)
                x >>= 16
            states[k] = ((x // f) << shift) + (x % f) + cm
    head = bytearray()
    for j in range(N):
        head += int(states[j]).to_bytes(4, "little")
    return bytes(head) + bytes(reversed(out))


class _U16Reader:
    def __init__(self, buf, pos):
        self.buf = buf
        self.pos = pos

    def u16(self) -> int:
        v = self.buf[self.pos] | (self.buf[self.pos + 1] << 8)
        self.pos += 2
        return v


def _rans_decode_core_o0(buf, pos: int, out_len: int, freqs: np.ndarray,
                         cum: np.ndarray, shift: int, N: int) -> Tuple[bytes, int]:
    mask = (1 << shift) - 1
    lookup = np.zeros(1 << shift, np.uint8)
    for s in range(256):
        f = int(freqs[s])
        if f:
            lookup[int(cum[s]):int(cum[s]) + f] = s
    states = []
    for j in range(N):
        states.append(int.from_bytes(buf[pos:pos + 4], "little"))
        pos += 4
    rd = _U16Reader(buf, pos)
    out = bytearray(out_len)
    for i in range(out_len):
        j = i % N
        x = states[j]
        m = x & mask
        s = int(lookup[m])
        out[i] = s
        x = int(freqs[s]) * (x >> shift) + m - int(cum[s])
        if x < _L:
            x = (x << 16) | rd.u16()
        states[j] = x
    return bytes(out), rd.pos


# ---------------------------------------------------------------- order-0 stream

def _encode_o0_payload(data: bytes, N: int) -> bytes:
    """Frequency table + rANS payload (no flags/size header — the 'Decode0' unit that
    order-1 table compression and RLE-meta compression also embed)."""
    counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    if len(data) == 0:
        # degenerate-but-well-formed table (PACK with one symbol packs to 0 bytes)
        counts = counts.copy()
        counts[0] = 1
    freqs = _normalize_freqs(counts, 1 << _TF_SHIFT_O0)
    cum = np.zeros(256, np.int64)
    cum[1:] = np.cumsum(freqs)[:-1]
    syms = [s for s in range(256) if freqs[s] > 0]
    out = bytearray(_encode_alphabet(syms))
    for s in syms:
        out += uint7_encode(int(freqs[s]))
    out += _rans_encode_core(data, freqs, cum, _TF_SHIFT_O0, N)
    return bytes(out)


def _decode_o0_payload(buf, pos: int, out_len: int, N: int) -> Tuple[bytes, int]:
    syms, pos = _decode_alphabet(buf, pos)
    freqs = np.zeros(256, np.int64)
    for s in syms:
        f, pos = uint7_decode(buf, pos)
        freqs[s] = f
    if int(freqs.sum()) != (1 << _TF_SHIFT_O0):
        raise ValueError(
            f"rans_nx16: order-0 frequencies sum to {int(freqs.sum())}, "
            f"want {1 << _TF_SHIFT_O0}"
        )
    cum = np.zeros(256, np.int64)
    cum[1:] = np.cumsum(freqs)[:-1]
    return _rans_decode_core_o0(buf, pos, out_len, freqs, cum, _TF_SHIFT_O0, N)


# ---------------------------------------------------------------- order-1 stream

def _o1_contexts(data: bytes, N: int) -> bytes:
    """Per-position context byte: previous byte within the fragment, 0 at fragment
    starts (each of the N states decodes its own fragment; the tail rides state N-1
    and continues its context chain)."""
    n = len(data)
    ctx = bytearray(n)
    frag = n // N
    for k in range(N):
        start = k * frag
        end = (k + 1) * frag if k < N - 1 else n
        prev = 0
        for i in range(start, end):
            ctx[i] = prev
            prev = data[i]
    return bytes(ctx)


def _encode_o1_payload(data: bytes, N: int, shift: int = _TF_SHIFT_O0) -> bytes:
    ctx = _o1_contexts(data, N)
    arr = np.frombuffer(data, np.uint8)
    carr = np.frombuffer(ctx, np.uint8)
    joint = np.zeros((256, 256), np.int64)
    np.add.at(joint, (carr, arr), 1)
    present = sorted(set(np.unique(carr).tolist()) | set(np.unique(arr).tolist()))
    total = 1 << shift
    freqs2 = np.zeros((256, 256), np.int64)
    cum2 = np.zeros((256, 256), np.int64)
    tbl = bytearray(_encode_alphabet(present))
    for c in present:
        row = joint[c]
        if row.sum() == 0:
            # context never used as predecessor: flat table over the alphabet keeps
            # the stream well-formed (decoder may build it; encoder never uses it)
            row = np.zeros(256, np.int64)
            row[present] = 1
        f = _normalize_freqs(row, total)
        freqs2[c] = f
        cum2[c][1:] = np.cumsum(f)[:-1]
        run = 0
        for j in present:
            if run > 0:
                run -= 1
                assert f[j] == 0
                continue
            tbl += uint7_encode(int(f[j]))
            if f[j] == 0:
                r = 0
                idx = present.index(j)
                while (idx + 1 + r < len(present)
                       and f[present[idx + 1 + r]] == 0 and r < 255):
                    r += 1
                tbl.append(r)
                run = r
    # header byte: shift<<4 | compressed-flag; compress the table with a raw order-0
    # unit when that wins
    comp = _encode_o0_payload(bytes(tbl), 4) if len(tbl) > 64 else None
    out = bytearray()
    if comp is not None and len(comp) + 8 < len(tbl):
        out.append((shift << 4) | 1)
        out += uint7_encode(len(comp))
        out += uint7_encode(len(tbl))
        out += comp
    else:
        out.append(shift << 4)
        out += bytes(tbl)
    out += _rans_encode_core(data, None, None, shift, N, ctx=ctx,
                             cum2=cum2, freqs2=freqs2)
    return bytes(out)


def _decode_o1_payload(buf, pos: int, out_len: int, N: int) -> Tuple[bytes, int]:
    hdr = buf[pos]
    pos += 1
    shift = hdr >> 4
    if shift not in (10, 12):
        raise ValueError(f"rans_nx16: unsupported order-1 shift {shift}")
    if hdr & 1:
        c_len, pos = uint7_decode(buf, pos)
        u_len, pos = uint7_decode(buf, pos)
        tbl, _ = _decode_o0_payload(buf[pos:pos + c_len], 0, u_len, 4)
        pos += c_len
        tpos_buf, tpos = tbl, 0
    else:
        tpos_buf, tpos = buf, pos
    present, tpos = _decode_alphabet(tpos_buf, tpos)
    total = 1 << shift
    freqs2 = np.zeros((256, 256), np.int64)
    for c in present:
        run = 0
        for j in present:
            if run > 0:
                run -= 1
                continue
            f, tpos = uint7_decode(tpos_buf, tpos)
            freqs2[c][j] = f
            if f == 0:
                run = tpos_buf[tpos]
                tpos += 1
        s = int(freqs2[c].sum())
        if s not in (0, total):
            raise ValueError(f"rans_nx16: order-1 context row sums to {s}")
    if not (hdr & 1):
        pos = tpos
    cum2 = np.zeros((256, 256), np.int64)
    cum2[:, 1:] = np.cumsum(freqs2, axis=1)[:, :-1]
    lookup = np.zeros((256, 1 << shift), np.uint8)
    for c in present:
        for j in present:
            f = int(freqs2[c][j])
            if f:
                lookup[c, int(cum2[c][j]):int(cum2[c][j]) + f] = j
    mask = total - 1
    states = []
    for k in range(N):
        states.append(int.from_bytes(buf[pos:pos + 4], "little"))
        pos += 4
    rd = _U16Reader(buf, pos)
    out = bytearray(out_len)
    frag = out_len // N
    cursors = [k * frag for k in range(N)]
    ends = [(k + 1) * frag for k in range(N - 1)] + [out_len]
    ctxs = [0] * N
    # round-robin schedule mirroring the encoder
    live = True
    while live:
        live = False
        for k in range(N):
            i = cursors[k]
            if i >= ends[k]:
                continue
            live = True
            x = states[k]
            m = x & mask
            s = int(lookup[ctxs[k]][m])
            out[i] = s
            x = (int(freqs2[ctxs[k]][s]) * (x >> shift)
                 + m - int(cum2[ctxs[k]][s]))
            if x < _L:
                x = (x << 16) | rd.u16()
            states[k] = x
            ctxs[k] = s
            cursors[k] = i + 1
    return bytes(out), rd.pos


# ---------------------------------------------------------------- transforms

def _pack_encode(data: bytes) -> Optional[Tuple[bytes, bytes]]:
    """Returns (meta, packed) or None when >16 distinct symbols."""
    syms = sorted(set(data))
    if len(syms) > 16 or not syms:
        return None
    meta = bytearray([len(syms)])
    meta += bytes(syms)
    idx = {s: i for i, s in enumerate(syms)}
    vals = [idx[b] for b in data]
    if len(syms) <= 1:
        packed = b""
    elif len(syms) <= 2:
        packed = bytearray((len(vals) + 7) // 8)
        for i, v in enumerate(vals):
            packed[i >> 3] |= v << (i & 7)
        packed = bytes(packed)
    elif len(syms) <= 4:
        packed = bytearray((len(vals) + 3) // 4)
        for i, v in enumerate(vals):
            packed[i >> 2] |= v << (2 * (i & 3))
        packed = bytes(packed)
    else:
        packed = bytearray((len(vals) + 1) // 2)
        for i, v in enumerate(vals):
            packed[i >> 1] |= v << (4 * (i & 1))
        packed = bytes(packed)
    meta += uint7_encode(len(packed))
    return bytes(meta), packed


def _pack_decode_meta(buf, pos: int) -> Tuple[List[int], int, int]:
    nsym = buf[pos]
    pos += 1
    syms = list(buf[pos:pos + nsym])
    pos += nsym
    plen, pos = uint7_decode(buf, pos)
    return syms, plen, pos


def _pack_decode(packed: bytes, syms: List[int], out_len: int) -> bytes:
    n = len(syms)
    if n == 0:
        raise ValueError("rans_nx16: PACK with empty symbol set")
    if n == 1:
        return bytes([syms[0]]) * out_len
    lut = np.asarray(syms, np.uint8)
    arr = np.frombuffer(packed, np.uint8)
    if n <= 2:
        bits = np.unpackbits(arr, bitorder="little")[:out_len]
        return lut[bits].tobytes()
    if n <= 4:
        vals = np.stack([(arr >> (2 * k)) & 3 for k in range(4)], 1).reshape(-1)
        return lut[vals[:out_len]].tobytes()
    vals = np.stack([arr & 15, arr >> 4], 1).reshape(-1)
    return lut[vals[:out_len]].tobytes()


def _rle_encode(data: bytes) -> Optional[Tuple[bytes, bytes]]:
    """Returns (meta, rle_stream): meta = [n_run_syms | syms | uint7 run lengths...],
    stream = literals with runs collapsed to one literal (length goes to meta)."""
    arr = np.frombuffer(data, np.uint8)
    if len(arr) == 0:
        return None
    # pick symbols whose runs save space: count run savings per symbol
    heads = np.concatenate([[True], arr[1:] != arr[:-1]])
    run_ids = np.cumsum(heads) - 1
    run_syms = arr[heads]
    run_lens = np.bincount(run_ids)
    save = np.zeros(256, np.int64)
    np.add.at(save, run_syms, run_lens - 2)  # approx: run collapses to sym+len byte
    use = [s for s in range(256) if save[s] > 0]
    if not use:
        return None
    use_set = set(use)
    meta = bytearray([len(use) & 0xFF])  # 256 encodes as 0
    meta += bytes(use)
    stream = bytearray()
    lens = bytearray()
    i = 0
    n = len(arr)
    data_b = data
    while i < n:
        s = data_b[i]
        if s in use_set:
            j = i + 1
            while j < n and data_b[j] == s:
                j += 1
            stream.append(s)
            lens += uint7_encode(j - i - 1)
            i = j
        else:
            stream.append(s)
            i += 1
    meta += bytes(lens)
    return bytes(meta), bytes(stream)


def _rle_decode(stream: bytes, meta: bytes, out_len: int) -> bytes:
    nsym = meta[0]
    if nsym == 0:
        nsym = 256
    syms = set(meta[1:1 + nsym])
    mpos = 1 + nsym
    out = bytearray()
    for s in stream:
        if s in syms:
            run, mpos = uint7_decode(meta, mpos)
            out += bytes([s]) * (run + 1)
        else:
            out.append(s)
    if len(out) != out_len:
        raise ValueError(
            f"rans_nx16: RLE expanded to {len(out)}, want {out_len}"
        )
    return bytes(out)


# ---------------------------------------------------------------- public API

def encode(data: bytes, order: int = 0, use_pack: bool = False,
           use_rle: bool = False, stripe: int = 0, nosz: bool = False,
           n32: bool = False) -> bytes:
    """Encode with explicit flags (the CRAM writer picks; tests sweep combinations)."""
    flags = 0
    out = bytearray()
    if len(data) == 0 and not stripe:
        out.append(F_CAT | (F_NOSZ if nosz else 0))
        if not nosz:
            out += uint7_encode(0)
        return bytes(out)
    if stripe:
        flags |= F_STRIPE
        if nosz:
            flags |= F_NOSZ
        out.append(flags)
        if not nosz:
            out += uint7_encode(len(data))
        X = stripe
        out.append(X)
        subs = []
        for j in range(X):
            subs.append(encode(data[j::X], order=order, use_pack=use_pack,
                               use_rle=use_rle, nosz=True, n32=n32))
        for s in subs:
            out += uint7_encode(len(s))
        for s in subs:
            out += s
        return bytes(out)

    N = 32 if n32 else 4
    if n32:
        flags |= F_N32
    payload = data
    pack_meta = rle_meta = None
    if use_pack:
        p = _pack_encode(payload)
        if p is not None:
            flags |= F_PACK
            pack_meta, payload = p
    if use_rle:
        r = _rle_encode(payload)
        if r is not None:
            flags |= F_RLE
            rle_meta, payload = r
    if order == 1 and len(payload) >= 2 * N:
        flags |= F_ORDER1
    if nosz:
        flags |= F_NOSZ
    # tiny payloads: CAT beats entropy coding and avoids degenerate tables
    if len(payload) < 8 and not (flags & (F_PACK | F_RLE)):
        out.append(flags | F_CAT)
        if not nosz:
            out += uint7_encode(len(data))
        out += payload
        return bytes(out)
    out.append(flags)
    if not nosz:
        out += uint7_encode(len(data))
    if flags & F_PACK:
        out += pack_meta
    if flags & F_RLE:
        # meta (possibly order-0 compressed) + rans-input length
        comp = _encode_o0_payload(rle_meta, 4) if len(rle_meta) > 64 else None
        if comp is not None and len(comp) + 8 < len(rle_meta):
            out += uint7_encode(len(rle_meta) << 1)  # even = compressed
            out += uint7_encode(len(payload))
            out += uint7_encode(len(comp))
            out += comp
        else:
            out += uint7_encode((len(rle_meta) << 1) | 1)  # odd = raw
            out += uint7_encode(len(payload))
            out += rle_meta
    if flags & F_ORDER1:
        out += _encode_o1_payload(payload, N)
    else:
        out += _encode_o0_payload(payload, N)
    return bytes(out)


def decode(data: bytes, expected_len: Optional[int] = None) -> bytes:
    """Decode one complete rANS Nx16 stream. ``expected_len`` is required when the
    stream was written with NOSZ. Uses the C++ shim's decoder when built
    (io/_native/rans_codec.cpp; differential-tested in tests/test_native_rans.py),
    falling back to this normative Python implementation."""
    import os

    if not os.environ.get("DENOVO_KMER_NO_NATIVE_RANS") and len(data) >= 1:
        from denovo_kmer_tpu_torch.io.native import rans_decode_native

        if data[0] & F_NOSZ:
            out_len = expected_len
        else:
            out_len, _ = uint7_decode(data, 1)
        if out_len is not None:
            got = rans_decode_native(data, out_len, nx16=True)
            if got is not None:
                return got

    buf = data
    pos = 0
    flags = buf[pos]
    pos += 1
    if flags & F_NOSZ:
        if expected_len is None:
            raise ValueError("rans_nx16: NOSZ stream needs an external length")
        ulen = expected_len
    else:
        ulen, pos = uint7_decode(buf, pos)
    if flags & F_STRIPE:
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
    if flags & F_CAT:
        return bytes(buf[pos:pos + ulen])
    N = 32 if flags & F_N32 else 4
    out_len = ulen
    pack_syms = None
    if flags & F_PACK:
        pack_syms, plen, pos = _pack_decode_meta(buf, pos)
        cur_len = plen
    else:
        cur_len = out_len
    rle_meta = None
    rle_out_len = None
    if flags & F_RLE:
        m, pos = uint7_decode(buf, pos)
        rans_len, pos = uint7_decode(buf, pos)
        rle_out_len = cur_len
        if m & 1:
            rle_meta = bytes(buf[pos:pos + (m >> 1)])
            pos += m >> 1
        else:
            c_len, pos = uint7_decode(buf, pos)
            rle_meta, _ = _decode_o0_payload(buf[pos:pos + c_len], 0, m >> 1, 4)
            pos += c_len
        cur_len = rans_len
    if flags & F_ORDER1:
        payload, pos = _decode_o1_payload(buf, pos, cur_len, N)
    else:
        payload, pos = _decode_o0_payload(buf, pos, cur_len, N)
    if flags & F_RLE:
        payload = _rle_decode(payload, rle_meta, rle_out_len)
    if flags & F_PACK:
        payload = _pack_decode(payload, pack_syms, out_len)
    if len(payload) != out_len:
        raise ValueError(f"rans_nx16: decoded {len(payload)} bytes, want {out_len}")
    return payload
