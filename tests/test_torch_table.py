"""Port tables (denovo_kmer_tpu_torch/ops/table.py, stream.py, score.py) against the JAX
package on the same numpy inputs: keys, counts, pcounts and n bit-equal, for W = 1..4,
inputs with no valid row, overflow (sticky n), uint32 count wraparound and the all-ones
strip rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.ops import score as jscore
from denovo_kmer_tpu.ops import stream as jstream
from denovo_kmer_tpu.ops import table as jtable
from denovo_kmer_tpu.ops.extract_fast import extract_canonical_kmers_fast
from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops.pack import pack_seqs as jax_pack_seqs
from denovo_kmer_tpu_torch.ops import score as tscore
from denovo_kmer_tpu_torch.ops import stream as tstream
from denovo_kmer_tpu_torch.ops import table as ttable
from denovo_kmer_tpu_torch.ops.extract import append_plain
from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor

torch.set_num_threads(1)

K_OF_W = {1: 15, 2: 31, 3: 33, 4: 63}


def _keys(rng, n, W, pool=None):
    """Random uint32 key rows of a W-word k-mer, drawn with repeats from a pool."""
    k = K_OF_W[W]
    pool = pool or max(n // 3, 1)
    uni = rng.integers(0, 2**32, size=(pool, W), dtype=np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        uni[:, 0] &= np.uint32((1 << top) - 1)
    return uni[rng.integers(0, pool, size=n)]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _jax_table(rng, n_rows, W, capacity):
    kmers = _keys(rng, n_rows, W)
    return jtable.build_table(jnp.asarray(kmers), jnp.ones((n_rows,), bool), capacity)


def _port_table(jt):
    return ttable.table_from_numpy(np.asarray(jt.keys), np.asarray(jt.counts), int(jt.n))


def _assert_table_equal(port, jax_t):
    keys, counts, n = ttable.table_to_numpy(port)
    np.testing.assert_array_equal(keys, np.asarray(jax_t.keys))
    np.testing.assert_array_equal(counts, np.asarray(jax_t.counts))
    assert n == int(jax_t.n)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("n_rows,capacity,valid_rate", [
    (400, 512, 0.8),    # fits, some invalid rows
    (400, 16, 0.9),     # overflow: n counts the true uniques, rows past capacity dropped
    (64, 128, 0.0),     # no valid row at all
])
def test_aggregate_multi_matches_jax(W, n_rows, capacity, valid_rate):
    rng = np.random.default_rng(100 * W + n_rows + capacity)
    kmers = _keys(rng, n_rows, W)
    # weights near 2^32 make group sums wrap, as the uint32 prefix differences do
    w0 = rng.integers(0, 2**32, size=n_rows, dtype=np.uint32)
    w1 = rng.integers(0, 4, size=n_rows, dtype=np.uint32)
    valid = rng.random(n_rows) < valid_rate
    jk, jcols, jn = jtable._aggregate_multi(
        jnp.asarray(kmers), [jnp.asarray(w0), jnp.asarray(w1)], jnp.asarray(valid), capacity)
    tk, tcols, tn = ttable._aggregate_multi(
        _t(kmers), [_t(w0), _t(w1)], torch.from_numpy(valid), capacity)
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32), np.asarray(jk))
    for tc, jc in zip(tcols, jcols):
        np.testing.assert_array_equal(tc.numpy().astype(np.uint32), np.asarray(jc))
    assert int(tn) == int(jn)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_build_table_matches_jax(W):
    rng = np.random.default_rng(50 + W)
    kmers = _keys(rng, 8 * 30, W).reshape(8, 30, W)
    valid = rng.random((8, 30)) < 0.8
    for cap in (256, 40):
        want = jtable.build_table(jnp.asarray(kmers), jnp.asarray(valid), cap)
        got = ttable.build_table(_t(kmers), torch.from_numpy(valid), cap)
        _assert_table_equal(got, want)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_flush_matches_jax(W):
    rng = np.random.default_rng(7 + W)
    C, S, fill = 256, 300, 240
    jt = _jax_table(rng, 150, W, C)
    staged = _keys(rng, S, W)
    valid = rng.random(S) < 0.85
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.asarray(valid), jnp.int32(fill))
    _, jout = jstream.flush(jacc, jt)
    tacc = tstream.KmerAccumulator(
        torch.from_numpy(staged.view(np.int32)), torch.from_numpy(valid), fill)
    tacc2, tout = tstream.flush(tacc, _port_table(jt))
    _assert_table_equal(tout, jout)
    assert tacc2.fill == 0


def test_flush_overflow_is_sticky():
    rng = np.random.default_rng(3)
    W, C = 2, 32
    staged = _keys(rng, 200, W, pool=150)
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.ones((200,), bool), jnp.int32(200))
    _, jout = jstream.flush(jacc, jtable.empty_table(C, W))
    tacc = tstream.KmerAccumulator(
        torch.from_numpy(staged.view(np.int32)), torch.ones(200, dtype=torch.bool), 200)
    _, tout = tstream.flush(tacc, ttable.empty_table(C, W))
    _assert_table_equal(tout, jout)
    assert int(tout.n) > C
    # a later flush of nothing recomputes n from the survivors; the overflow stays visible
    empty = tstream.empty_accumulator(8, W)
    _, again = tstream.flush(empty, tout)
    _, jagain = jstream.flush(jstream.empty_accumulator(8, W), jout)
    _assert_table_equal(again, jagain)
    assert int(again.n) > C


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_merge_tables_matches_jax(W):
    rng = np.random.default_rng(11 + W)
    ja, jb = _jax_table(rng, 200, W, 128), _jax_table(rng, 90, W, 64)
    for cap in (256, 24):
        jm = jtable.merge_tables(ja, jb, cap)
        tm = ttable.merge_tables(_port_table(ja), _port_table(jb), cap)
        _assert_table_equal(tm, jm)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_probe_table_matches_jax(W):
    rng = np.random.default_rng(21 + W)
    jt = _jax_table(rng, 300, W, 256)
    present = np.asarray(jt.keys)[: int(jt.n)][rng.integers(0, int(jt.n), size=40)]
    queries = np.concatenate([present, _keys(rng, 40, W), np.full((3, W), 0xFFFFFFFF,
                                                                   np.uint32)])
    want = np.asarray(jtable.probe_table(jt, jnp.asarray(queries)))
    got = ttable.probe_table(_port_table(jt), _t(queries))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (want[:40] > 0).all()


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_seed_flush_score_and_call_match_jax(W):
    rng = np.random.default_rng(31 + W)
    jm, jd = _jax_table(rng, 220, W, 128), _jax_table(rng, 260, W, 128)
    tm, td = _port_table(jm), _port_table(jd)
    jseed = jscore.seed_score_table(jm, jd, 256)
    tseed = tscore.seed_score_table(tm, td, 256)
    for jx, tx in zip(jseed, tseed):
        np.testing.assert_array_equal(tx.numpy().astype(np.uint32), np.asarray(jx))

    S, fill = 400, 350
    staged = np.concatenate([np.asarray(jm.keys)[:100], _keys(rng, S - 100, W)])
    valid = rng.random(S) < 0.9
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.asarray(valid), jnp.int32(fill))
    tacc = tstream.KmerAccumulator(torch.from_numpy(staged.view(np.int32)),
                                   torch.from_numpy(valid), fill)
    _, jflushed = jscore.flush_score(jacc, jseed, out_capacity=512)
    _, tflushed = tscore.flush_score(tacc, tseed, out_capacity=512)
    keys, counts, pcounts, n = tscore.score_table_to_numpy(tflushed)
    np.testing.assert_array_equal(keys, np.asarray(jflushed.keys))
    np.testing.assert_array_equal(counts, np.asarray(jflushed.counts))
    np.testing.assert_array_equal(pcounts, np.asarray(jflushed.pcounts))
    assert n == int(jflushed.n)

    for tau, mcc in ((0, 1), (1, 2)):
        jc = jscore.call_from_score(jflushed, tau, mcc)
        tc = tscore.call_from_score(tflushed, tau, mcc)
        assert int(tc.n) == int(jc.n) > 0
        for jx, tx in zip(jc[:4], tc[:4]):
            np.testing.assert_array_equal(tx.numpy().astype(np.uint32), np.asarray(jx))


def test_flush_score_overflow_is_sticky():
    rng = np.random.default_rng(5)
    W = 2
    jm, jd = _jax_table(rng, 100, W, 64), _jax_table(rng, 100, W, 64)
    jseed = jscore.seed_score_table(jm, jd, 128)
    tseed = tscore.seed_score_table(_port_table(jm), _port_table(jd), 128)
    staged = _keys(rng, 300, W, pool=300)
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.ones((300,), bool), jnp.int32(300))
    tacc = tstream.KmerAccumulator(torch.from_numpy(staged.view(np.int32)),
                                   torch.ones(300, dtype=torch.bool), 300)
    _, jout = jscore.flush_score(jacc, jseed)
    _, tout = tscore.flush_score(tacc, tseed)
    assert int(tout.n) == int(jout.n) > 128


@pytest.mark.parametrize("real_all_ones", [True, False])
def test_all_ones_strip_rule_matches_jax(real_all_ones):
    """k=16, forward strand: an all-T read makes the real all-ones key 0xFFFFFFFF, which
    must be kept; without it the invalid rows' all-ones weight-0 group is stripped."""
    k, L = 16, 32
    cfg = JaxConfig(k=k, canonical=False, max_read_len=L, batch_reads=4,
                    table_capacity=64)
    seqs = ["ACGTNACGTACGTACGTACGTACG", "CCCCGGGGAAAATTTTCCCCG"]
    if real_all_ones:
        seqs.append("T" * 20)
    packed = jax_pack_seqs(seqs, cfg, batch_size=4)
    jk, jv = extract_canonical_kmers_fast(
        jnp.asarray(packed.words), jnp.asarray(packed.vwords), k, L, canonical=False)
    S = jk.shape[0] * jk.shape[1]
    jacc = jstream.append(jstream.empty_accumulator(S, 1), jk, jv)
    _, jout = jstream.flush(jacc, jtable.empty_table(64, 1))

    tacc = append_plain(tstream.empty_accumulator(S, 1), as_int32_tensor(packed.words),
                        as_int32_tensor(packed.vwords), None, k, L, canonical=False)
    _, tout = tstream.flush(tacc, ttable.empty_table(64, 1))
    _assert_table_equal(tout, jout)
    keys, counts, n = ttable.table_to_numpy(tout)
    has_ones = bool((keys[:n, 0] == 0xFFFFFFFF).any())
    assert has_ones == real_all_ones
    if real_all_ones:
        assert counts[n - 1] == 5  # 20 - 16 + 1 windows of the all-T read


def test_table_numpy_round_trip():
    rng = np.random.default_rng(9)
    jt = _jax_table(rng, 300, 3, 256)
    keys, counts, n = ttable.table_to_numpy(_port_table(jt))
    assert keys.dtype == np.uint32 and counts.dtype == np.uint32
    np.testing.assert_array_equal(keys, np.asarray(jt.keys))
    np.testing.assert_array_equal(counts, np.asarray(jt.counts))
    assert n == int(jt.n)
    jseed = jscore.seed_score_table(jt, jt, 512)
    back = tscore.score_table_to_numpy(tscore.score_table_from_numpy(
        *(np.asarray(x) for x in jseed[:3]), int(jseed.n)))
    for a, b in zip(back[:3], jseed[:3]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert back[3] == int(jseed.n)
