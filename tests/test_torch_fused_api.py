"""The public protocol of the port's fused call (denovo_kmer_tpu_torch/ops/fused.py) against
the JAX package's on the CPU, on seeded inputs (tests/test_fused.py's): the packed
``(K+1, W+3)`` output of ``fused_flush_call`` under both variant names, ``unpack_fused``,
``extract_candidates`` and its ``CandidateOverflowError``, ``fused_call_candidates``, the
capacity K, the variant names and ``DENOVO_FUSED_VARIANT``, and the scan helpers
``segmented_suffix_sums`` (also against tests/test_fused.py's numpy oracle) and
``extract_rows_2level``. Candidate rows and the scalars are bit-exact; the rows past the
candidates are padding (zero in the port, a copy of a sorted row in JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.ops import fused as jfused
from denovo_kmer_tpu.ops import score as jscore
from denovo_kmer_tpu.ops import stream as jstream
from denovo_kmer_tpu.ops import table as jtable
from denovo_kmer_tpu_torch.ops import fused as tfused
from denovo_kmer_tpu_torch.ops import score as tscore
from denovo_kmer_tpu_torch.ops import stream as tstream

torch.set_num_threads(1)


def _rand_kmers(rng, n, W, k):
    kk = rng.integers(0, 2**32, size=(n, W), dtype=np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        kk[:, 0] &= np.uint32((1 << top) - 1)
    return kk


def _table(kmers, reps, capacity):
    stream = kmers[np.repeat(np.arange(len(kmers)), reps)]
    return jtable.build_table(jnp.asarray(stream)[None], jnp.ones((1, len(stream)), bool),
                              capacity)


def _accs(staged, valid, fill):
    jacc = jstream.KmerAccumulator(jnp.asarray(staged), jnp.asarray(valid), jnp.int32(fill))
    tacc = tstream.KmerAccumulator(torch.from_numpy(staged.view(np.int32)),
                                   torch.from_numpy(valid), fill)
    return jacc, tacc


def _port_score(jtab):
    return tscore.score_table_from_numpy(*(np.asarray(x) for x in jtab[:3]), int(jtab.n),
                                         "cpu")


def _inputs(k, W, seed=0, n_uni=400, S=1500):
    """A seeded score table (parents sharing some keys) and a staged child window with
    duplicates and invalid rows: (JAX seed, port seed, JAX acc, port acc)."""
    rng = np.random.default_rng(seed)
    uni = _rand_kmers(rng, n_uni, W, k)
    mom = _table(uni[: n_uni // 2], rng.integers(1, 4, n_uni // 2), 512)
    dad = _table(uni[n_uni // 4: 3 * n_uni // 4], rng.integers(1, 4, n_uni // 2), 512)
    seed_tab = jscore.seed_score_table(mom, dad, 1024)
    staged = uni[rng.integers(n_uni // 3, n_uni, size=S)]
    jacc, tacc = _accs(staged, rng.random(S) < 0.9, S - 37)
    return seed_tab, _port_score(seed_tab), jacc, tacc


def _same_packed(got, want):
    """Candidate rows and scalars of two packed outputs agree."""
    g, w = tfused.unpack_fused(got), jfused.unpack_fused(want)
    assert (g.n_cand, g.n_unique, g.n_child_unique) == (w.n_cand, w.n_unique,
                                                        w.n_child_unique)
    assert g.keys.shape == w.keys.shape
    n = min(g.n_cand, g.keys.shape[0])
    for a, b in ((g.keys, w.keys), (g.child, w.child), (g.momc, w.momc), (g.dadc, w.dadc)):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a[:n], np.asarray(b)[:n])
    assert g.carry_risk == 0
    return g


@pytest.mark.parametrize("k,capacity", [(15, None), (20, None), (21, None), (31, 1000),
                                        (15, 1 << 20)])
def test_default_max_candidates_matches_jax(k, capacity):
    assert tfused.DEFAULT_MAX_CANDIDATES == jfused.DEFAULT_MAX_CANDIDATES
    assert tfused.default_max_candidates(k, capacity) == jfused.default_max_candidates(
        k, capacity)


@pytest.mark.parametrize("variant", ["v4", "v5"])
@pytest.mark.parametrize("k,W", [(15, 1), (31, 2), (41, 3), (63, 4)])
def test_fused_flush_call_matches_jax(k, W, variant):
    jseed, tseed, jacc, tacc = _inputs(k, W, seed=k)
    for tau, mcc in ((0, 2), (2, 1)):
        want = jfused.fused_flush_call(jacc, jseed, tau, mcc, variant=variant)
        got = tfused.fused_flush_call(tacc, tseed, tau, mcc, variant=variant)
        assert tuple(got.shape) == tuple(want.shape) == (jfused.DEFAULT_MAX_CANDIDATES + 1,
                                                         W + 3)
        g = _same_packed(got, want)
        assert g.n_cand > 0
        assert not got[g.n_cand:-1].any()  # padding rows are zero


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_candidate_capacity_overflow_and_retry_match_jax(variant, monkeypatch):
    """tests/test_fused.py:144: 300 child-only candidates against K = 64."""
    monkeypatch.setenv("DENOVO_FUSED_VARIANT", variant)
    k, W = 21, 2
    rng = np.random.default_rng(11)
    child_only = _rand_kmers(rng, 300, W, k)
    mom = _table(_rand_kmers(rng, 10, W, k), np.full(10, 2), 64)
    dad = _table(_rand_kmers(rng, 10, W, k), np.full(10, 2), 64)
    jseed = jscore.seed_score_table(mom, dad, 64)
    stream = child_only[np.repeat(np.arange(300), 2)]
    staged = np.zeros((1024, W), np.uint32)
    staged[: len(stream)] = stream
    valid = np.zeros(1024, bool)
    valid[: len(stream)] = True
    jacc, tacc = _accs(staged, valid, len(stream))
    tseed = _port_score(jseed)
    want = jfused.fused_flush_call(jacc, jseed, 0, 2, max_candidates=64)
    got = tfused.fused_flush_call(tacc, tseed, 0, 2, max_candidates=64)
    assert tuple(got.shape) == (65, W + 3)
    assert _same_packed(got, want).n_cand == 300
    with pytest.raises(tfused.CandidateOverflowError, match="retry with max_candidates >= 300"):
        tfused.extract_candidates(got)
    jc = jfused.fused_call_candidates(jacc, jseed, 0, 2, max_candidates=64)
    tc = tfused.fused_call_candidates(tacc, tseed, 0, 2, max_candidates=64)
    assert int(tc.n) == int(jc.n) == 300
    for a, b in zip(tc[:4], jc[:4]):
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_empty_and_no_candidate_windows_match_jax(variant):
    """tests/test_fused.py:159: an empty staging buffer over parents holding every key."""
    k, W = 21, 2
    rng = np.random.default_rng(3)
    uni = _rand_kmers(rng, 20, W, k)
    mom = _table(uni, np.full(20, 5), 64)
    jseed = jscore.seed_score_table(mom, mom, 64)
    jacc = jstream.empty_accumulator(128, W)
    tacc = tstream.empty_accumulator(128, W, "cpu")
    tseed = _port_score(jseed)
    want = jfused.fused_flush_call(jacc, jseed, 0, 1, variant=variant)
    got = tfused.fused_flush_call(tacc, tseed, 0, 1, variant=variant)
    assert _same_packed(got, want).n_cand == 0
    keys, cc, mc, dc = tfused.extract_candidates(got)
    assert keys.shape == (0, W) and cc.shape == mc.shape == dc.shape == (0,)
    assert int(tfused.fused_call_candidates(tacc, tseed, 0, 1).n) == 0


def test_fused_call_candidates_matches_jax():
    jseed, tseed, jacc, tacc = _inputs(31, 2, seed=9)
    want = jfused.fused_call_candidates(jacc, jseed, 0, 2)
    got = tfused.fused_call_candidates(tacc, tseed, 0, 2)
    assert int(got.n) == int(want.n) > 0
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))


def test_unpack_fused_reads_the_jax_layout():
    """The port's ``unpack_fused`` reads a JAX packed array as JAX's does."""
    jseed, _, jacc, _ = _inputs(31, 2, seed=4)
    packed = jfused.fused_flush_call(jacc, jseed, 0, 2, max_candidates=256, variant="v4")
    g, w = tfused.unpack_fused(np.asarray(packed)), jfused.unpack_fused(packed)
    assert tuple(g)[:3] == tuple(w)[:3] and g.carry_risk == w.carry_risk
    for a, b in zip(g[3:7], w[3:7]):
        np.testing.assert_array_equal(a, b)
    keys, cc, mc, dc = tfused.extract_candidates(np.asarray(packed))
    for a, b in zip((keys, cc, mc, dc), jfused.extract_candidates(packed)):
        np.testing.assert_array_equal(a, b)


def test_result_does_not_depend_on_capacity_or_variant():
    _, tseed, _, tacc = _inputs(41, 3, seed=2)
    base = tfused.fused_call_full(tacc, tseed, 0, 2)
    assert len(base[0]) > 1
    for K, variant in ((1, "v4"), (1, "v5"), (1 << 20, None)):
        got = tfused.fused_call_full(tacc, tseed, 0, 2, max_candidates=K, variant=variant)
        for a, b in zip(got[:4], base[:4]):
            np.testing.assert_array_equal(a, b)
        assert got[4:] == base[4:]


def test_unknown_variant_raises_key_error_as_in_jax(monkeypatch):
    jseed, tseed, jacc, tacc = _inputs(21, 2, seed=1, S=200)
    for call in (tfused.fused_flush_call, tfused.fused_call_full):
        with pytest.raises(KeyError):
            call(tacc, tseed, 0, 1, variant="v6")
    with pytest.raises(KeyError):
        jfused.fused_flush_call(jacc, jseed, 0, 1, variant="v6")
    monkeypatch.setenv("DENOVO_FUSED_VARIANT", "v6")
    for call in (tfused.fused_flush_call, tfused.fused_call_full):
        with pytest.raises(KeyError):
            call(tacc, tseed, 0, 1)
    with pytest.raises(KeyError):
        jfused.fused_flush_call(jacc, jseed, 0, 1)
    tfused.fused_flush_call(tacc, tseed, 0, 1, variant="v4")  # a named variant wins


def test_carry_risk_input_is_exact_without_a_rerun():
    """tests/test_fused.py:177's input, a carried count of 2^31 - 1: JAX's v5 reports carry
    risk 1 (its wrapper reruns through v4); the port's packed output is exact, risk 0."""
    k, W = 21, 2
    rng = np.random.default_rng(5)
    keys = _rand_kmers(rng, 4, W, k)
    keys = keys[np.lexsort(keys.T[::-1])]
    tk = np.full((8, W), 0xFFFFFFFF, np.uint32)
    tk[:4] = keys
    counts = np.array([2, (1 << 31) - 1, 3, 4, 0, 0, 0, 0], np.uint32)
    pcounts = np.array([1, 0, 2 | (3 << 16), 0, 0, 0, 0, 0], np.uint32)
    jtab = jscore.ScoreTable(keys=jnp.asarray(tk), counts=jnp.asarray(counts),
                             pcounts=jnp.asarray(pcounts), n=jnp.asarray(4, jnp.int32))
    jacc = jstream.empty_accumulator(128, W)
    tacc = tstream.empty_accumulator(128, W, "cpu")
    assert jfused.unpack_fused(jfused.fused_flush_call(jacc, jtab, 3, 1, 16, "v5")).carry_risk
    want = jfused.fused_flush_call(jacc, jtab, 3, 1, 16, "v4")
    got = tfused.fused_flush_call(tacc, _port_score(jtab), 3, 1, 16, "v5")
    assert (1 << 31) - 1 in _same_packed(got, want).child


def _suffix_oracle(head, v):
    """tests/test_fused.py:294's scalar oracle: the suffix sum within each segment."""
    N = len(v)
    out = np.zeros(N, np.uint64)
    seg_end = N
    for i in range(N - 1, -1, -1):
        out[i] = v[i] + (out[i + 1] if i + 1 < seg_end else 0)
        if head[i]:
            seg_end = i
    return out.astype(np.uint32)


@pytest.mark.parametrize("groups", ["random", "one_row", "whole_stream"])
@pytest.mark.parametrize("N", [1, 5, 127, 128, 129, 300, 1024, 4097])
def test_segmented_suffix_sums_matches_jax_and_oracle(N, groups):
    rng = np.random.default_rng(N)
    head = {"random": rng.random(N) < 0.3, "one_row": np.ones(N, bool),
            "whole_stream": np.zeros(N, bool)}[groups]
    head[0] = True
    # values near 2^32 so that group sums wrap as uint32 sums do
    v1 = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    v2 = rng.integers(0, 1 << 20, N).astype(np.uint32)
    want = jfused.segmented_suffix_sums(jnp.asarray(head), jnp.asarray(v1), jnp.asarray(v2))
    got = tfused.segmented_suffix_sums(torch.from_numpy(head),
                                       torch.from_numpy(v1.astype(np.int64)),
                                       torch.from_numpy(v2.view(np.int32)))
    assert len(got) == 2
    for g, w, v in zip(got, want, (v1, v2)):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), _suffix_oracle(head, v))


@pytest.mark.parametrize("N,K,density", [(1, 4, 1.0), (129, 64, 0.2), (300, 16, 0.1),
                                         (1000, 8, 0.5), (4097, 32, 0.003)])
def test_extract_rows_2level_matches_jax(N, K, density):
    """Flagged rows in order, padding rows at index N-1, more flags than K cut at K."""
    rng = np.random.default_rng(N + K)
    flags = rng.random(N) < density
    cols = [rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    n_cand = int(flags.sum())
    want, widx = jfused.extract_rows_2level(jnp.asarray(flags), jnp.int32(n_cand),
                                            [jnp.asarray(c) for c in cols], K)
    got, gidx = tfused.extract_rows_2level(torch.from_numpy(flags), torch.tensor(n_cand),
                                           [torch.from_numpy(c.astype(np.int64))
                                            for c in cols], K)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


def test_group_heads_matches_jax():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 6, (500, 2)).astype(np.uint32)
    words = words[np.lexsort(words.T[::-1])]
    want = jfused.group_heads([jnp.asarray(words[:, w]) for w in range(2)])
    got = tfused.group_heads([torch.from_numpy(words[:, w].astype(np.int64))
                              for w in range(2)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
