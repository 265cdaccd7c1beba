"""Adaptive range coder + byte-wise adaptive models (CRAM 3.1 archive codecs).

CRAM 3.1's three archive-profile codecs — adaptive arithmetic (block method 6),
fqzcomp quality (method 7), and the tok3 name tokenizer's arithmetic mode
(method 8) — all sit on one entropy-coding substrate, specified in the
"Adaptive arithmetic coding" section of the hts-specs CRAMcodecs document:

  * a carry-counting byte-oriented range coder (the Shelwien/Subbotin lineage
    the spec's pseudocode presents): 32-bit range, 64-bit low to catch carries,
    renormalization when range < 2^24, one pending-0xFF counter, 5-byte prime
    on the decode side (the first emitted byte is the encoder's initial empty
    cache and carries no payload);
  * small adaptive frequency models ("SIMPLE_MODEL"): per-symbol counts
    incremented by a fixed STEP on every coded symbol, halved when the total
    crosses MAX_FREQ, with a one-place bubble toward the front of the symbol
    array on each update so frequent symbols are found early — the bubble is
    part of the coded state (cumulative frequencies depend on array order), so
    encoder and decoder must replay it identically.

This is a clean-room implementation from the specification; no htslib/htscodecs
binary exists in this environment, so (same posture as io/rans_nx16.py) bit-level
interop with foreign encoders is validated by spec-derived structure + roundtrip +
differential tests only, and should be re-verified against upstream when tooling
is available. Reference dependency set: /root/reference/.github/workflows/ci.yml:24-25
(bz2/lzma -> full htslib CRAM stack).

The port's copy of ``denovo_kmer_tpu/io/range_coder.py``; its imports point at the port.
"""

from __future__ import annotations

from typing import List

_TOP = 1 << 24


class RangeEncoder:
    """Carry-counting range encoder. Output = one leading cache byte (initially
    empty, emitted as 0x00) + payload; finish() flushes 5 tail bytes so the
    decoder's 5-byte prime always has data to read."""

    __slots__ = ("low", "range", "cache", "ff_num", "out")

    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.ff_num = 0
        self.out = bytearray()

    def encode(self, cum_freq: int, freq: int, tot_freq: int) -> None:
        r = self.range // tot_freq
        self.low += cum_freq * r
        self.range = r * freq
        while self.range < _TOP:
            self._shift_low()
            self.range <<= 8

    def _shift_low(self) -> None:
        low = self.low
        if (low & 0xFFFFFFFF) < 0xFF000000 or low > 0xFFFFFFFF:
            carry = low >> 32
            # very first flush emits the initial empty cache (0) + carry — the
            # dummy lead byte the decoder's 5-byte prime shifts off the top
            self.out.append((self.cache + carry) & 0xFF)
            while self.ff_num:
                self.out.append((0xFF + carry) & 0xFF)
                self.ff_num -= 1
            self.cache = (low >> 24) & 0xFF
        else:
            self.ff_num += 1
        self.low = (low << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("buf", "pos", "range", "code")

    def __init__(self, buf, pos: int = 0) -> None:
        self.buf = buf
        self.pos = pos
        self.range = 0xFFFFFFFF
        code = 0
        for _ in range(5):
            code = ((code << 8) | self._in()) & 0xFFFFFFFFFF
        # the first primed byte is the encoder's initial cache flush; after five
        # shifts into a 32-bit window it has fallen off the top
        self.code = code & 0xFFFFFFFF

    def _in(self) -> int:
        p = self.pos
        if p < len(self.buf):
            self.pos = p + 1
            return self.buf[p]
        # zero-fill past the end: the encoder's 5-byte tail flush means a
        # well-formed stream never reads past EOF for real payload; corrupt
        # streams surface as model/total mismatches upstream
        self.pos = p + 1
        return 0

    def get_freq(self, tot_freq: int) -> int:
        self.range //= tot_freq
        return self.code // self.range

    def decode(self, cum_freq: int, freq: int) -> None:
        # get_freq already divided range by tot_freq
        self.code -= cum_freq * self.range
        self.range *= freq
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._in()) & 0xFFFFFFFF
            self.range <<= 8


# ------------------------------------------------------------------ adaptive model

_STEP = 16
_MAX_FREQ = (1 << 16) - 16


class SimpleModel:
    """Adaptive frequency model over ``nsym`` symbols (0..nsym-1), all starting
    at frequency 1. Linear scan with move-toward-front bubbling; the array order
    is coded state shared by encoder and decoder."""

    __slots__ = ("total", "freqs", "syms")

    def __init__(self, nsym: int) -> None:
        self.total = nsym
        self.freqs: List[int] = [1] * nsym
        self.syms: List[int] = list(range(nsym))

    def _update(self, i: int) -> None:
        freqs = self.freqs
        freqs[i] += _STEP
        self.total += _STEP
        if self.total > _MAX_FREQ:
            t = 0
            for j in range(len(freqs)):
                f = freqs[j] - (freqs[j] >> 1)
                freqs[j] = f
                t += f
            self.total = t
        if i > 0 and freqs[i] > freqs[i - 1]:
            freqs[i - 1], freqs[i] = freqs[i], freqs[i - 1]
            s = self.syms
            s[i - 1], s[i] = s[i], s[i - 1]

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        syms = self.syms
        freqs = self.freqs
        acc = 0
        i = 0
        while syms[i] != sym:
            acc += freqs[i]
            i += 1
        rc.encode(acc, freqs[i], self.total)
        self._update(i)

    def decode(self, rc: RangeDecoder) -> int:
        target = rc.get_freq(self.total)
        if target >= self.total:
            raise ValueError("range_coder: corrupt stream (frequency out of range)")
        freqs = self.freqs
        acc = 0
        i = 0
        while acc + freqs[i] <= target:
            acc += freqs[i]
            i += 1
        rc.decode(acc, freqs[i])
        sym = self.syms[i]
        self._update(i)
        return sym
