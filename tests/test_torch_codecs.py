"""The port's CRAM block codecs (denovo_kmer_tpu_torch/io/{rans,rans_nx16,arith,fqz,tok3,
range_coder}.py and the native decoders of its io/_native/) against the JAX package's, on
payloads made from a numpy seed: each JAX-encoded stream decodes through the port to the
same bytes, and the port's encoders write the JAX encoders' bytes. Every case runs with the
port's native library and with it switched off (the pure-Python decoders). The CRAM 3.0 spec
fixtures of tests/test_cram_fixtures.py (HUFFMAN, BETA, five-byte ITF8, the order-0 rANS of
the spec pseudocode, the version error) run against the port's reader. Tolerance: equal."""

import io
import shutil

import numpy as np
import pytest

from denovo_kmer_tpu.io import arith as jax_arith
from denovo_kmer_tpu.io import fqz as jax_fqz
from denovo_kmer_tpu.io import rans as jax_rans
from denovo_kmer_tpu.io import rans_nx16 as jax_nx16
from denovo_kmer_tpu.io import tok3 as jax_tok3
from denovo_kmer_tpu_torch.io import arith, cram, fqz, native, rans, rans_nx16, tok3

from test_cram_fixtures import _bits, spec_encode_o0  # noqa: E402 (spec fixtures)


@pytest.fixture(params=["native", "python"])
def mode(request, monkeypatch):
    """``native``: the port's library decodes (skips without g++); ``python``: the library
    is switched off, so every codec takes its pure-Python decoder."""
    if request.param == "native":
        if shutil.which("g++") is None:
            pytest.skip("no g++: the native codecs cannot build")
        assert native.native_available(), native.native_build_error()
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_error", "switched off for the test")
        monkeypatch.setattr(cram, "_ITF8_RUN", None)
    return request.param


def _payloads():
    rng = np.random.default_rng(3)
    qual = bytes(rng.choice([30, 35, 40, 2], p=[.5, .3, .15, .05], size=3000)
                 .astype(np.uint8))
    seq = bytes(rng.choice([65, 67, 71, 84], size=2500).astype(np.uint8))
    rnd = bytes(rng.integers(0, 256, 1500).astype(np.uint8))
    runs = b"".join(bytes([int(s)]) * int(r) for s, r in
                    zip(rng.integers(0, 5, 300), rng.integers(1, 30, 300)))
    return {"qual": qual, "seq": seq, "rnd": rnd, "runs": runs,
            "tiny": b"xyzxyzxyzx", "one": b"Q", "empty": b""}


PAYLOADS = _payloads()


@pytest.mark.parametrize("order", [0, 1])
def test_rans4x8(order, mode):
    for name, data in PAYLOADS.items():
        enc = jax_rans.encode(data, order=order)
        assert rans.encode(data, order=order) == enc, name
        assert rans.decode(enc) == data, name


NX16_VARIANTS = {
    "plain": {}, "pack": dict(use_pack=True), "rle": dict(use_rle=True),
    "pack_rle": dict(use_pack=True, use_rle=True), "n32": dict(n32=True),
    "stripe": dict(stripe=4, use_pack=True, use_rle=True), "nosz": dict(nosz=True),
}


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("variant", sorted(NX16_VARIANTS))
def test_rans_nx16(order, variant, mode):
    """Order 0 and 1 with PACK, RLE, STRIPE, N32 and NOSZ; the empty and one-byte payloads
    come out as CAT (stored raw) blocks."""
    kw = NX16_VARIANTS[variant]
    for name, data in PAYLOADS.items():
        enc = jax_nx16.encode(data, order=order, **kw)
        assert rans_nx16.encode(data, order=order, **kw) == enc, name
        got = rans_nx16.decode(enc, len(data) if kw.get("nosz") else None)
        assert got == data, name
    assert rans_nx16.encode(b"", order=order)[0] & 0x20  # CAT


ARITH_VARIANTS = {
    "plain": {}, "rle": dict(use_rle=True), "pack": dict(use_pack=True),
    "stripe": dict(stripe=4, use_rle=True), "ext": dict(ext=True),
}


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("variant", sorted(ARITH_VARIANTS))
def test_arith(order, variant, mode):
    kw = ARITH_VARIANTS[variant]
    for name, data in PAYLOADS.items():
        enc = jax_arith.encode(data, order=order, **kw)
        assert arith.encode(data, order=order, **kw) == enc, name
        assert arith.decode(enc) == data, name


@pytest.mark.parametrize("dedup", [False, True])
def test_fqz(dedup, mode):
    rng = np.random.default_rng(7)
    lens = [151] * 12 + [90, 151, 0, 37, 151]
    quals = rng.choice([2, 12, 23, 37], p=[.05, .15, .2, .6], size=sum(lens))
    if dedup:
        quals[151:302] = quals[:151]  # a repeated quality string: one dedup bit
    data = bytes(quals.astype(np.uint8))
    enc = jax_fqz.encode(data, lens, dedup=dedup)
    assert fqz.encode(data, lens, dedup=dedup) == enc
    assert fqz.decode(enc) == data


@pytest.mark.parametrize("use_arith", [False, True])
def test_tok3(use_arith, mode):
    rng = np.random.default_rng(11)
    names = [f"M01234:55:000000000-A1B2C:1:{1100 + i // 50}:{10000 + int(x)}:{int(y):05d}"
             for i, (x, y) in enumerate(zip(rng.integers(0, 20000, 120),
                                            rng.integers(0, 99999, 120)))]
    for data in (("\x00".join(names) + "\x00").encode(), b"read1\x00" * 30, b""):
        enc = jax_tok3.encode(data, use_arith=use_arith)
        assert tok3.encode(data, use_arith=use_arith) == enc
        assert tok3.decode(enc) == data


def test_native_decoders_match_and_reject_corrupt(mode):
    """The port's ctypes entry points on JAX-encoded streams: the same bytes (None when the
    library is off), and a malformed block raises rather than returning garbage."""
    data = PAYLOADS["qual"]
    enc = jax_nx16.encode(data, order=1, use_rle=True)
    got = native.rans_decode_native(enc, len(data), nx16=True)
    if mode == "python":
        assert got is None
        return
    assert got == data
    assert native.rans_decode_native(jax_rans.encode(data, 1), len(data), False) == data
    bad = bytearray(jax_nx16.encode(b"ACGTACGT" * 500, order=0))
    bad[8] ^= 0x3F  # first frequency byte: breaks the sum invariant
    with pytest.raises(ValueError, match="native rANS"):
        native.rans_decode_native(bytes(bad), 4000, nx16=True)


# --------------- the CRAM 3.0 spec fixtures, against the port's reader ---------------

def test_itf8_five_byte_and_edges():
    for v in (0, 1, 127, 128, 1 << 14, (1 << 28) - 1, 1 << 28, -1, -(1 << 31)):
        enc = cram.itf8_encode(v)
        got, pos = cram.itf8_decode(enc, 0)
        assert got == v and pos == len(enc)
    assert len(cram.itf8_encode(-1)) == 5
    assert cram.itf8_decode(cram.itf8_encode(0xFFFFFFFF), 0)[0] == -1


def test_huffman_canonical_and_single_symbol():
    e = cram.itf8_encode
    params = e(3) + e(67) + e(65) + e(66) + e(3) + e(2) + e(1) + e(2)
    dec = cram._Decoder(cram.Encoding(cram.E_HUFFMAN, params),
                        cram._BitReader(_bits("0 10 11 0 11")), {})
    assert [dec.read_int() for _ in range(5)] == [65, 66, 67, 65, 67]
    core = cram._BitReader(b"")
    one = cram._Decoder(cram.Encoding(cram.E_HUFFMAN, e(1) + e(42) + e(1) + e(0)), core, {})
    assert [one.read_int() for _ in range(3)] == [42, 42, 42]
    assert core.pos == 0 and core.bit == 0


def test_beta_and_byte_array_len():
    e = cram.itf8_encode
    dec = cram._Decoder(cram.Encoding(cram.E_BETA, e(2) + e(5)),
                        cram._BitReader(_bits("00111 11111 00000")), {})
    assert [dec.read_int() for _ in range(3)] == [5, 29, -2]
    len_params, val_params = e(0) + e(4), e(7)
    params = (e(cram.E_BETA) + e(len(len_params)) + len_params
              + e(cram.E_EXTERNAL) + e(len(val_params)) + val_params)
    dec = cram._Decoder(cram.Encoding(cram.E_BYTE_ARRAY_LEN, params),
                        cram._BitReader(_bits("0011 0010")), {7: cram._ByteStream(b"XYZpq")})
    assert dec.read_bytes() == b"XYZ" and dec.read_bytes() == b"pq"


@pytest.mark.parametrize("payload", [b"abracadabra" * 40, bytes(range(256)) * 3,
                                     b"\x00" * 1000, b"ACGTacgtNNNN" * 97])
def test_rans_o0_spec_encoder(payload, mode):
    assert rans.decode(spec_encode_o0(payload)) == payload


def test_cram_version_error():
    for major, minor in ((2, 0), (3, 2)):
        with pytest.raises(ValueError, match="not supported"):
            cram.CramReader(io.BytesIO(b"CRAM" + bytes([major, minor]) + b"\x00" * 40))
