"""The port's standalone extraction (denovo_kmer_tpu_torch/ops/extract_fast.py) and
``ops.extract.unpack_codes`` against the JAX package on the CPU: the (B, P) and transposed
(P, B) layouts at k = 15, 21, 31, 33, 63 (W = 1..4), canonical and not, on reads with N,
bit-exact against ``extract_canonical_kmers_fast`` and the Pallas kernel in interpret mode
(tests/test_extract_fast.py, tests/test_extract_pallas.py); keys are held at valid windows,
and on the CPU at every window. On a card the same call launches the extraction kernel."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops import extract as jextract
from denovo_kmer_tpu.ops import extract_fast as jfast
from denovo_kmer_tpu.ops.extract_pallas import extract_canonical_kmers_pallas
from denovo_kmer_tpu.ops.pack import _pack_codes, pack_seqs, padded_length
from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor
from denovo_kmer_tpu_torch.ops import extract as textract
from denovo_kmer_tpu_torch.ops import extract_fast as tfast

KS = [15, 21, 31, 33, 63]


def _seqs(k, seed, n=12):
    rng = random.Random(seed)
    max_len = max(70, k + 5)
    seqs = ["".join(rng.choice("ACGTN") for _ in range(rng.randrange(k, max_len + 1)))
            for _ in range(n)]
    return seqs + ["A" * max_len, "T" * max_len, "N" * max_len], max_len


def _packed(k, seed):
    seqs, max_len = _seqs(k, seed)
    return pack_seqs(seqs, JaxConfig(k=k, max_read_len=max_len)), max_len


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", KS)
def test_fast_extract_matches_jax(k, canonical):
    p, max_len = _packed(k, k * 31 + canonical)
    want_k, want_v = jfast.extract_canonical_kmers_fast(
        jnp.asarray(p.words), jnp.asarray(p.vwords), k, max_len, canonical=canonical)
    got_k, got_v = tfast.extract_canonical_kmers_fast(
        as_int32_tensor(p.words), as_int32_tensor(p.vwords), k, max_len, canonical=canonical)
    wv = np.asarray(want_v)
    assert got_k.shape == want_k.shape and got_v.shape == want_v.shape
    np.testing.assert_array_equal(got_v.numpy(), wv)
    gk = got_k.numpy().astype(np.uint32)
    np.testing.assert_array_equal(gk[wv], np.asarray(want_k)[wv])
    # the CPU's plain version is the JAX arithmetic, so invalid windows agree as well
    np.testing.assert_array_equal(gk, np.asarray(want_k))


@pytest.mark.parametrize("k", KS)
def test_fast_t_is_the_transpose(k):
    p, max_len = _packed(k, k)
    words, vwords = as_int32_tensor(p.words), as_int32_tensor(p.vwords)
    bk, bv = tfast.extract_canonical_kmers_fast(words, vwords, k, max_len)
    tk, tv = tfast.extract_canonical_kmers_fast_t(words, vwords, k, max_len)
    assert torch.equal(tv, bv.T) and torch.equal(tk, bk.transpose(0, 1))
    jk, jv = jfast.extract_canonical_kmers_fast_t(
        jnp.asarray(p.words), jnp.asarray(p.vwords), k, max_len)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32)[tv.numpy()],
                                  np.asarray(jk)[np.asarray(jv)])


@pytest.mark.parametrize("k,max_len", [(15, 48), (31, 96), (33, 96), (63, 128)])
def test_fast_extract_matches_the_pallas_kernel(k, max_len):
    """The TPU kernel this entry stands for on the card, in interpret mode."""
    rng = np.random.default_rng(k)
    seqs = ["".join(np.where(rng.random(L) < 0.01, "N", rng.choice(list("ACGT"), L)))
            for L in rng.integers(max_len // 3, max_len + 1, 32)]
    p = pack_seqs(seqs, JaxConfig(k=k, max_read_len=max_len, batch_reads=32), batch_size=32)
    want_k, want_v = extract_canonical_kmers_pallas(
        jnp.asarray(p.words), jnp.asarray(p.vwords), k, max_len, interpret=True,
        block_reads=16)
    got_k, got_v = tfast.extract_canonical_kmers_fast(
        as_int32_tensor(p.words), as_int32_tensor(p.vwords), k, max_len)
    wv = np.asarray(want_v)
    np.testing.assert_array_equal(got_v.numpy(), wv)
    np.testing.assert_array_equal(got_k.numpy().astype(np.uint32)[wv],
                                  np.asarray(want_k)[wv])


def test_int64_values_and_int32_bits_give_one_result():
    p, max_len = _packed(31, 5)
    a = tfast.extract_canonical_kmers_fast(as_int32_tensor(p.words),
                                           as_int32_tensor(p.vwords), 31, max_len)
    b = tfast.extract_canonical_kmers_fast(torch.from_numpy(p.words.astype(np.int64)),
                                           torch.from_numpy(p.vwords.astype(np.int64)),
                                           31, max_len, barrier=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cpu_tensors_launch_no_kernel():
    p, max_len = _packed(21, 3)
    before = textract.extract_append.launches
    tfast.extract_canonical_kmers_fast(as_int32_tensor(p.words), as_int32_tensor(p.vwords),
                                       21, max_len)
    assert textract.extract_append.launches == before


@pytest.mark.parametrize("max_len", [32, 64, 160])
def test_vwords_from_lengths_matches_jax(max_len):
    assert tfast.vwords_from_lengths is textract.vwords_from_lengths
    rng = np.random.default_rng(max_len)
    Lp = padded_length(max_len)
    lens = rng.integers(0, max_len + 1, 37).astype(np.int32)
    want = np.asarray(jfast.vwords_from_lengths(jnp.asarray(lens), Lp))
    got = tfast.vwords_from_lengths(torch.from_numpy(lens), Lp).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("max_len", [32, 100, 160])
def test_unpack_codes_matches_jax(max_len):
    rng = np.random.default_rng(max_len + 1)
    Lp = padded_length(max_len)
    B = 19
    lens = rng.integers(0, max_len + 1, B).astype(np.int32)
    codes = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    valid = (np.arange(Lp)[None, :] < lens[:, None]) & (rng.random((B, Lp)) > 0.05)
    p = _pack_codes(np.where(valid, codes, 0).astype(np.uint8), valid, lens, B)
    jc, jv = jextract.unpack_codes(jnp.asarray(p.words), jnp.asarray(p.vwords), Lp)
    tc, tv = textract.unpack_codes(as_int32_tensor(p.words), as_int32_tensor(p.vwords), Lp)
    np.testing.assert_array_equal(tc.numpy().astype(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", KS)
def test_fast_extract_launches_the_kernel_on_the_card(card, k, canonical):
    """One launch a call; validity everywhere and keys at valid windows as on the CPU."""
    p, max_len = _packed(k, k)
    words, vwords = as_int32_tensor(p.words), as_int32_tensor(p.vwords)
    want_k, want_v = tfast.extract_canonical_kmers_fast(words, vwords, k, max_len, canonical)
    before = textract.extract_append.launches
    got_k, got_v = tfast.extract_canonical_kmers_fast(words.to(card), vwords.to(card), k,
                                                      max_len, canonical)
    assert textract.extract_append.launches == before + 1
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(got_k.cpu()[want_v], want_k[want_v])
