"""The port's plain extraction (denovo_kmer_tpu_torch/ops/extract.py) against the JAX
package: ``extract_canonical_kmers_fast`` and the Pallas kernel in interpret mode, on random
reads with Ns and mixed lengths. Valid masks are compared exactly, keys where valid. The
CUDA kernel of the same module is held against this plain version on the card by
chip_smoke.py (there is no card here)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops.extract_fast import extract_canonical_kmers_fast
from denovo_kmer_tpu.ops.extract_pallas import extract_canonical_kmers_pallas
from denovo_kmer_tpu.ops.pack import pack_seqs as jax_pack_seqs
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor
from denovo_kmer_tpu_torch.ops.extract import (
    _chunk_words,
    _lanes_per_read,
    extract_append,
    extract_canonical_kmers,
    vwords_from_lengths,
)
from denovo_kmer_tpu_torch.ops.pack import pack_seqs
from denovo_kmer_tpu_torch.ops.stream import empty_accumulator

torch.set_num_threads(1)

MATRIX = [(15, 48), (21, 64), (31, 96), (33, 96), (41, 128), (63, 128)]


def _rand_reads(rng, n, max_len, n_rate=0.01):
    out = []
    for _ in range(n):
        L = int(rng.integers(max_len // 3, max_len + 1))
        bases = rng.choice(list("ACGT"), size=L)
        bases[rng.random(L) < n_rate] = "N"
        out.append("".join(bases))
    return out


def _packed(k, max_len, n_rate=0.01):
    rng = np.random.default_rng(k * 1000 + max_len)
    cfg = EngineConfig(k=k, max_read_len=max_len, batch_reads=64, table_capacity=1 << 10)
    return pack_seqs(_rand_reads(rng, 64, max_len, n_rate), cfg, batch_size=64)


def _assert_same(got_k, got_v, want_k, want_v):
    want_v = np.asarray(want_v)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(
        got_k.numpy().astype(np.uint32)[want_v], np.asarray(want_k)[want_v])


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k,max_len", MATRIX)
def test_plain_matches_jax_fast(k, max_len, canonical):
    p = _packed(k, max_len)
    want_k, want_v = extract_canonical_kmers_fast(
        jnp.asarray(p.words), jnp.asarray(p.vwords), k, max_len, canonical=canonical)
    got_k, got_v = extract_canonical_kmers(
        as_int32_tensor(p.words), as_int32_tensor(p.vwords), k, max_len, canonical)
    assert got_k.shape == (64, max_len - k + 1, -(-2 * k // 32))
    _assert_same(got_k, got_v, want_k, want_v)
    assert want_v.any()


@pytest.mark.parametrize("k,max_len", MATRIX)
def test_plain_matches_jax_pallas_interpret(k, max_len):
    p = _packed(k, max_len)
    want_k, want_v = extract_canonical_kmers_pallas(
        jnp.asarray(p.words), jnp.asarray(p.vwords), k, max_len, interpret=True,
        block_reads=16)
    got_k, got_v = extract_canonical_kmers(
        as_int32_tensor(p.words), as_int32_tensor(p.vwords), k, max_len, True)
    _assert_same(got_k, got_v, want_k, want_v)


@pytest.mark.parametrize("max_len", [48, 64, 100, 160])
def test_vwords_from_lengths_matches_jax_pack(max_len):
    """The validity words the JAX package's ``_pack_codes`` builds for clean reads."""
    rng = np.random.default_rng(max_len)
    cfg = JaxConfig(k=15, max_read_len=max_len, batch_reads=64, table_capacity=1 << 10)
    p = jax_pack_seqs(_rand_reads(rng, 60, max_len, 0.0), cfg, batch_size=64)
    assert p.prefix_valid
    got = vwords_from_lengths(torch.from_numpy(p.length), p.padded_len)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), p.vwords)


def test_pack_matches_jax_pack():
    rng = np.random.default_rng(4)
    seqs = _rand_reads(rng, 50, 151)
    quals = [tuple(int(q) for q in rng.integers(0, 41, len(s))) for s in seqs]
    kw = dict(k=31, max_read_len=160, batch_reads=64, min_base_quality=20)
    got = pack_seqs(seqs, EngineConfig(**kw), quals, batch_size=64)
    want = jax_pack_seqs(seqs, JaxConfig(**kw), quals, batch_size=64)
    for name in ("words", "vwords", "length"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.n_reads, got.prefix_valid) == (want.n_reads, want.prefix_valid)


@pytest.mark.parametrize("k,max_len", [(21, 64), (31, 160), (33, 96), (63, 128)])
def test_extract_append_lengths_equals_vwords(k, max_len):
    """A length-shipped batch stages exactly what the same batch with vwords stages."""
    p = _packed(k, max_len, n_rate=0.0)
    assert p.prefix_valid
    words = as_int32_tensor(p.words)
    W, P = -(-2 * k // 32), max_len - k + 1
    a = extract_append(empty_accumulator(3 * 64 * P, W), words, None,
                       torch.from_numpy(p.length), k, max_len)
    b = extract_append(empty_accumulator(3 * 64 * P, W), words, as_int32_tensor(p.vwords),
                       None, k, max_len)
    assert a.fill == b.fill == 64 * P
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    v = b.valid.numpy()
    np.testing.assert_array_equal(a.kmers.numpy()[v], b.kmers.numpy()[v])
    # rows land at fill + b*P + p: a second append continues after the first
    c = extract_append(b, words, as_int32_tensor(p.vwords), None, k, max_len)
    assert c.fill == 2 * 64 * P
    np.testing.assert_array_equal(c.valid.numpy()[64 * P: 2 * 64 * P], v[: 64 * P])


def test_extract_append_checks_its_inputs():
    p = _packed(31, 96, n_rate=0.0)
    words = as_int32_tensor(p.words)
    acc = empty_accumulator(64 * 66, 2)
    with pytest.raises(TypeError):
        extract_append(acc, words.to(torch.int64), None, torch.from_numpy(p.length), 31, 96)
    with pytest.raises(ValueError):  # staging has room for one batch only
        extract_append(extract_append(acc, words, None, torch.from_numpy(p.length), 31, 96),
                       words, None, torch.from_numpy(p.length), 31, 96)
    with pytest.raises(ValueError):  # k=33 needs 3-word keys
        extract_append(acc, words, None, torch.from_numpy(p.length), 33, 96)
    with pytest.raises(ValueError):
        extract_append(acc, words, None, None, 31, 96)
    with pytest.raises(ValueError):
        extract_append(acc, words[:, :4].contiguous(), None, torch.from_numpy(p.length),
                       31, 96)


def test_kernel_tile_fits_shared_memory():
    """The kernel stages no read tile in shared memory: a read's words sit in the lanes of a
    warp. At the main path (Lp=160: Lw=10, k=31: W=2, P=130) a read is one chunk on 32
    lanes; at 64-base reads (P=34) two reads share a warp; a 1024-base read (Lw=64) takes
    three chunks."""
    assert _chunk_words(31) == 28 and 10 + 2 + 1 <= 32
    assert _lanes_per_read(10, 31, 130) == 32
    assert _lanes_per_read(4, 31, 34) == 16
    assert -(-(1024 - 63 + 1) // (16 * _chunk_words(63))) == 3


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63])
def test_kernel_chunk_fits_a_warp(k):
    """A warp's chunk of a read: its words and the W + 1 a window reads past its first fit
    32 lanes, and it starts on a whole validity word."""
    W = -(-2 * k // 32)
    S = _chunk_words(k)
    assert S % 2 == 0 and S + W + 1 <= 32 and S + W + 3 > 32
    # the main path's reads (160 bases, 10 words) are one chunk at every k
    assert 10 <= S


@pytest.mark.parametrize("Lw,k,max_len,lanes", [
    (4, 31, 64, 16),     # 34 windows: 3 half-warp steps against 2 warp steps, 30 lanes idle
    (4, 32, 64, 16),     # 33 windows
    (4, 15, 48, 16),     # W = 1, 34 windows
    (6, 47, 80, 16),     # W = 3, 34 windows
    (4, 63, 64, 16),     # W = 4, 2 windows
    (2, 31, 32, 16),     # 2 windows
    (10, 31, 160, 32),   # 130 windows: 4.5 against 5 warp steps
    (8, 31, 112, 32),    # 82 windows
    (6, 15, 80, 32),     # 66 windows
    (10, 63, 160, 32),   # 98 windows
    (2, 15, 32, 32),     # 18 windows: no fewer warp steps
    (14, 31, 66, 32),    # 14 + 3 words do not fit 16 lanes
    (38, 15, 600, 32),   # a read of several chunks
])
def test_kernel_gives_reads_half_a_warp_where_lanes_would_idle(Lw, k, max_len, lanes):
    assert _lanes_per_read(Lw, k, max_len - k + 1) == lanes


@pytest.mark.parametrize("k,max_len,chunks", [(31, 160, 1), (15, 600, 2), (63, 1024, 3),
                                              (33, 4096, 10)])
def test_long_reads_take_several_chunks(k, max_len, chunks):
    """Reads wider than one chunk (over 512 bases) still stage every window: the plain
    version's rows, which the kernel reproduces chunk by chunk on the card."""
    P = max_len - k + 1
    assert -(-P // (16 * _chunk_words(k))) == chunks
    p = _packed(k, max_len, n_rate=0.0)
    acc = extract_append(empty_accumulator(64 * P, -(-2 * k // 32)), as_int32_tensor(p.words),
                         None, torch.from_numpy(p.length), k, max_len)
    assert acc.fill == 64 * P
    lengths = p.length.astype(np.int64)
    want = (np.arange(P)[None, :] + k <= lengths[:, None]).reshape(-1)
    np.testing.assert_array_equal(acc.valid.numpy(), want)


@pytest.fixture(scope="module")
def jax_pass_step():
    from denovo_kmer_tpu.pipeline import make_ingest_step as jax_make_ingest_step

    cfg = JaxConfig(k=31, max_read_len=96, batch_reads=64, table_capacity=1 << 10)
    return cfg, jax_make_ingest_step(cfg, n_passes=3)[0]


@pytest.mark.parametrize("pass_id", [0, 1, 2])
@pytest.mark.parametrize("feed", ["vwords", "lengths"])
def test_pass_filter_matches_jax_ingest_step(jax_pass_step, pass_id, feed):
    """``n_passes=3``: the staged rows and valid mask of JAX's multipass ingest step."""
    from denovo_kmer_tpu.ops.stream import empty_accumulator as jax_empty_accumulator
    from denovo_kmer_tpu_torch.pipeline import make_ingest_step

    jcfg, jstep = jax_pass_step
    p = _packed(31, 96, n_rate=0.01 if feed == "vwords" else 0.0)
    assert p.prefix_valid == (feed == "lengths")
    P = 96 - 31 + 1
    want = jstep.append_packed(jax_empty_accumulator(64 * P, 2), p, jnp.uint32(pass_id))
    placed = dataclasses.replace(
        p, words=as_int32_tensor(p.words),
        vwords=None if feed == "lengths" else as_int32_tensor(p.vwords),
        length=as_int32_tensor(p.length))
    step = make_ingest_step(EngineConfig(k=31, max_read_len=96, batch_reads=64,
                                         table_capacity=1 << 10), n_passes=3)
    got = step(empty_accumulator(64 * P, 2), placed, pass_id)
    want_v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), want_v)
    np.testing.assert_array_equal(got.kmers.numpy().view(np.uint32)[want_v],
                                  np.asarray(want.kmers)[want_v])
    assert 0 < want_v.sum() < 0.5 * 64 * P  # about a third of the windows stay


def test_pass_filters_partition_the_windows():
    """The three passes' valid masks are disjoint and cover the unfiltered mask."""
    p = _packed(21, 64)
    args = (as_int32_tensor(p.words), as_int32_tensor(p.vwords), None, 21, 64)
    rows = 64 * (64 - 21 + 1)
    full = extract_append(empty_accumulator(rows, 2), *args)
    masks = [extract_append(empty_accumulator(rows, 2), *args, n_passes=3, pass_id=i).valid
             for i in range(3)]
    assert torch.equal(masks[0] | masks[1] | masks[2], full.valid)
    assert not (masks[0] & masks[1]).any() and not (masks[1] & masks[2]).any()
    with pytest.raises(ValueError, match="pass_id"):
        extract_append(empty_accumulator(rows, 2), *args, n_passes=3, pass_id=3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 15, 16, 31, 32, 33, 47, 48, 63])
def test_kernel_edges_match_plain_on_the_card(card, k):
    """Unaligned fills into a buffer whose other rows hold a sentinel that must survive,
    1 and 17 reads, the bucket widths and a width over 512 bases (several chunks), both
    feeds: valid masks and every staged row bit-exact against the plain version."""
    from denovo_kmer_tpu_torch.ops.extract import append_plain

    W = -(-2 * k // 32)
    for max_len, B in ((32, 17), (48, 1), (64, 1), (80, 17), (112, 17), (160, 17), (600, 17)):
        if max_len < k:
            continue
        P = max_len - k + 1
        for n_rate in (0.0, 0.02):
            p = _packed(k, max_len, n_rate)
            words = as_int32_tensor(p.words)[:B].to(card)
            vwords = as_int32_tensor(p.vwords)[:B].to(card) if n_rate else None
            lengths = None if n_rate else as_int32_tensor(p.length)[:B].to(card)
            for fill in (0, 1, 3, 5):
                accs = []
                for run in (extract_append, append_plain):
                    acc = empty_accumulator(fill + B * P + 7, W, card)
                    acc.kmers.fill_(-0x12345679)
                    acc.valid.fill_(True)
                    accs.append(run(acc._replace(fill=fill), words, vwords, lengths, k,
                                    max_len))
                got, want = accs
                assert got.fill == want.fill == fill + B * P
                assert torch.equal(got.valid, want.valid), (max_len, B, fill)
                rows = want.valid.clone()
                rows[:fill] = True
                rows[fill + B * P:] = True
                assert torch.equal(got.kmers[rows], want.kmers[rows]), (max_len, B, fill)
