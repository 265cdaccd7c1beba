"""The port's tables at the JAX package's width, held against the JAX package on the CPU:
key words, counts and parental packs are int32 tensors of the uint32 values' bits (4W+4 B a
KmerTable row, 4W+8 B a ScoreTable row); the numpy converters view JAX's arrays without a
copy; counts wrap at 2^32 as JAX's uint32 sums wrap and saturate into the parental pack as
JAX's do; probes and the lexicographic compare order words unsigned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.ops import score as jscore
from denovo_kmer_tpu.ops import stream as jstream
from denovo_kmer_tpu.ops import table as jtable
from denovo_kmer_tpu_torch.ops import score as tscore
from denovo_kmer_tpu_torch.ops import stream as tstream
from denovo_kmer_tpu_torch.ops import table as ttable

torch.set_num_threads(1)

TOP = np.uint32(1 << 31)
ALL_ONES = np.uint32(0xFFFFFFFF)


def _high_keys(rng, n, W):
    """n distinct (n, W) uint32 keys, every word >= 2^31, the last one all ones."""
    keys = rng.integers(0, 1 << 31, size=(4 * n, W), dtype=np.uint32) | TOP
    keys = np.unique(keys, axis=0)[: n - 1]
    return np.concatenate([keys, np.full((1, W), ALL_ONES)])


def _jax_table(keys, counts, capacity):
    """A JAX KmerTable of sorted unique ``keys`` with ``counts``, padded to ``capacity``."""
    n, W = keys.shape
    k = np.full((capacity, W), ALL_ONES)
    c = np.zeros(capacity, np.uint32)
    k[:n], c[:n] = keys, counts
    return jtable.KmerTable(jnp.asarray(k), jnp.asarray(c), jnp.int32(n))


def _bits_pointer(a):
    return a.__array_interface__["data"][0]


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_table_round_trip_is_a_view_of_the_jax_arrays(W):
    """Every word at or above 2^31, the all-ones key and padding: the port's table views
    JAX's arrays (int32, no widened copy), costs 4W+4 B a row, and converts back to the same
    uint32 arrays; a scoring table the same at 4W+8 B a row."""
    rng = np.random.default_rng(W)
    keys = _high_keys(rng, 50, W)
    counts = (rng.integers(0, 1 << 31, size=50, dtype=np.uint32) | TOP)
    jt = _jax_table(keys, counts, 64)
    hk, hc = np.asarray(jt.keys), np.asarray(jt.counts)
    t = ttable.table_from_numpy(hk, hc, int(jt.n), "cpu")
    assert t.keys.dtype == t.counts.dtype == torch.int32 and t.n.dtype == torch.int64
    assert t.keys.data_ptr() == _bits_pointer(hk) and t.counts.data_ptr() == _bits_pointer(hc)
    assert t.keys.element_size() * W + t.counts.element_size() == 4 * W + 4
    back_k, back_c, n = ttable.table_to_numpy(t)
    assert back_k.dtype == back_c.dtype == np.uint32 and n == 50
    np.testing.assert_array_equal(back_k, hk)
    np.testing.assert_array_equal(back_c, hc)
    assert ttable.empty_table(8, W, "cpu").keys.dtype == torch.int32

    js = jscore.seed_score_table(jt, jt, 128)
    sk, sc, sp = (np.asarray(x) for x in (js.keys, js.counts, js.pcounts))
    s = tscore.score_table_from_numpy(sk, sc, sp, int(js.n), "cpu")
    assert s.keys.data_ptr() == _bits_pointer(sk) and s.pcounts.data_ptr() == _bits_pointer(sp)
    assert (s.keys.element_size() * W + s.counts.element_size() + s.pcounts.element_size()
            == 4 * W + 8)
    for got, want in zip(tscore.score_table_to_numpy(s)[:3], (sk, sc, sp)):
        np.testing.assert_array_equal(got, want)
    assert tscore.empty_score_table(8, W, "cpu").pcounts.dtype == torch.int32


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_the_port_builds_tables_at_the_jax_width(W):
    """A flush, a merge and a seed all hand back int32 tables."""
    rng = np.random.default_rng(10 + W)
    keys = _high_keys(rng, 30, W)
    jt = _jax_table(keys, np.arange(1, 31, dtype=np.uint32), 64)
    t = ttable.table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts), 30, "cpu")
    acc = tstream.empty_accumulator(16, W, "cpu")
    acc = tstream.append(acc, torch.from_numpy(keys[:16].astype(np.int64)),
                         torch.ones(16, dtype=torch.bool))
    _, flushed = tstream.flush(acc, t)
    merged = ttable.merge_tables(t, t, 64)
    seed = tscore.seed_score_table(t, t, 64)
    for tab in (flushed, merged):
        assert tab.keys.dtype == tab.counts.dtype == torch.int32
    assert seed.keys.dtype == seed.counts.dtype == seed.pcounts.dtype == torch.int32


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_counts_wrap_at_2_32_as_jax_uint32_sums(W):
    """Counts near 2^32 summed by merge_tables, flush and flush_score, and counts at or
    above 2^31 saturated into the seed's parental pack: equal to the JAX package's."""
    rng = np.random.default_rng(20 + W)
    keys = _high_keys(rng, 40, W)
    big = (np.uint32(0xFFFFFFF0) - rng.integers(0, 8, size=40, dtype=np.uint32))
    small = rng.integers(1, 1 << 10, size=40, dtype=np.uint32)
    ja, jb = _jax_table(keys, big, 64), _jax_table(keys, small, 64)

    def port(jt):
        return ttable.table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts),
                                       int(jt.n), "cpu")

    want = jtable.merge_tables(ja, jb, 64)
    got = ttable.merge_tables(port(ja), port(jb), 64)
    np.testing.assert_array_equal(ttable.table_to_numpy(got)[1], np.asarray(want.counts))
    assert (np.asarray(want.counts)[:40] < big).any()  # some sums wrapped

    staged = np.concatenate([keys[:20], keys[:20]])
    valid = np.ones(40, bool)
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.asarray(valid), jnp.int32(40))

    def tacc():
        return tstream.KmerAccumulator(torch.from_numpy(staged.view(np.int32)).clone(),
                                       torch.from_numpy(valid), 40)

    _, jf = jstream.flush(jacc, ja)
    _, tf = tstream.flush(tacc(), port(ja))
    np.testing.assert_array_equal(ttable.table_to_numpy(tf)[1], np.asarray(jf.counts))

    jseed = jscore.seed_score_table(ja, jb, 128)
    tseed = tscore.seed_score_table(port(ja), port(jb), 128)
    for got, want in zip(tscore.score_table_to_numpy(tseed), (jseed.keys, jseed.counts,
                                                              jseed.pcounts, jseed.n)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert (np.asarray(jseed.pcounts)[:40] & 0xFFFF == 0xFFFF).all()  # mom saturated
    wrapped = jscore.ScoreTable(jseed.keys, jnp.asarray(np.where(
        np.arange(128) < 40, np.uint32(0xFFFFFFFF), np.uint32(0))), jseed.pcounts, jseed.n)
    twrapped = tscore.score_table_from_numpy(*(np.asarray(x) for x in wrapped[:3]),
                                             int(wrapped.n), "cpu")
    _, js = jscore.flush_score(jacc, wrapped)
    _, ts = tscore.flush_score(tacc(), twrapped)
    for got, want in zip(tscore.score_table_to_numpy(ts), (js.keys, js.counts, js.pcounts,
                                                           js.n)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert (np.asarray(js.counts)[:20] == 1).all()  # 0xFFFFFFFF + 2 wraps to 1


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_probe_orders_words_unsigned(W):
    """Keys whose words differ in the top bit: probe_table finds every present key (counts
    at or above 2^31 too) and 0 for absent ones, equal to the JAX probe; _lex_less on int32
    bits orders a word at or above 2^31 after one below it."""
    rng = np.random.default_rng(30 + W)
    low = rng.integers(0, 1 << 31, size=(60, W), dtype=np.uint32)
    keys = np.unique(np.concatenate([low, low | TOP, low ^ TOP]), axis=0)
    n = keys.shape[0]
    counts = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    jt = _jax_table(keys, counts, 1 << (n.bit_length() + 1))
    t = ttable.table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts), n, "cpu")
    absent = np.unique(rng.integers(0, 1 << 32, size=(80, W), dtype=np.uint64)
                       .astype(np.uint32), axis=0)
    queries = np.concatenate([keys, absent, keys ^ TOP])
    want = np.asarray(jtable.probe_table(jt, jnp.asarray(queries)))
    for q in (torch.from_numpy(queries.astype(np.int64)),
              torch.from_numpy(queries.view(np.int32))):
        got = ttable.probe_table(t, q)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (want[:n] == counts).all()

    a = torch.from_numpy((low[:, 0] | TOP).view(np.int32))
    b = torch.from_numpy(low[:, 0].view(np.int32))
    assert not ttable._lex_less([a], [b]).any()
    assert ttable._lex_less([b], [a]).all()
    if W > 1:  # equal first words: the second word decides, unsigned
        hi = torch.from_numpy(low[:, 0].view(np.int32))
        lo_big = torch.from_numpy((low[:, 1] | TOP).view(np.int32))
        lo_small = torch.from_numpy((low[:, 1] & ~TOP).view(np.int32))
        assert ttable._lex_less([hi, lo_small], [hi, lo_big]).all()
        assert not ttable._lex_less([hi, lo_big], [hi, lo_small]).any()
