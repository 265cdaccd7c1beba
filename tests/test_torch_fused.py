"""The port's fused call (denovo_kmer_tpu_torch/ops/fused.py) against the JAX
``fused_call_full`` in both sort formulations (v4, v5) on random seeded tables and staged
streams: candidate keys and counts, n_unique and n_child_unique bit-equal."""

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


def _assert_same(got, want):
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[4:] == tuple(int(x) for x in want[4:])


def _trio_inputs(rng, k, W, n_uni=400, S=1500):
    uni = _rand_kmers(rng, n_uni, W, k)
    mom = _table(uni[: n_uni // 2], rng.integers(1, 4, n_uni // 2), 512)
    dad = _table(uni[n_uni // 4: 3 * n_uni // 4], rng.integers(1, 4, n_uni // 2), 512)
    staged = uni[rng.integers(n_uni // 3, n_uni, size=S)]
    valid = rng.random(S) < 0.9
    return mom, dad, staged, valid


@pytest.mark.parametrize("variant", ["v4", "v5"])
@pytest.mark.parametrize("k,W", [(15, 1), (31, 2), (41, 3), (63, 4)])
def test_fused_call_matches_jax(k, W, variant):
    assert tfused.fused_supported(k)
    rng = np.random.default_rng(k)
    mom, dad, staged, valid = _trio_inputs(rng, k, W)
    seed = jscore.seed_score_table(mom, dad, 1024)
    fill = len(staged) - 37  # rows past fill are ignored
    jacc, tacc = _accs(staged, valid, fill)
    for tau, mcc in ((0, 2), (2, 1)):
        want = jfused.fused_call_full(jacc, seed, tau, mcc, variant=variant)
        got = tfused.fused_call_full(tacc, _port_score(seed), tau, mcc)
        _assert_same(got, want)
        assert len(got[0]) > 0


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_fused_call_after_compacting_flush_matches_jax(variant):
    """The score table already holds carried child counts from an earlier window."""
    k, W = 31, 2
    rng = np.random.default_rng(77)
    mom, dad, staged, valid = _trio_inputs(rng, k, W)
    seed = jscore.seed_score_table(mom, dad, 1024)
    jacc0, tacc0 = _accs(staged, valid, len(staged))
    _, jtab = jscore.flush_score(jacc0, seed, out_capacity=2048)
    _, ttab = tscore.flush_score(tacc0, _port_score(seed), out_capacity=2048)
    staged2 = staged[rng.permutation(len(staged))]
    jacc, tacc = _accs(staged2, np.ones(len(staged2), bool), 900)
    want = jfused.fused_call_full(jacc, jtab, 0, 2, variant=variant)
    got = tfused.fused_call_full(tacc, ttab, 0, 2)
    _assert_same(got, want)


def test_fused_call_empty_window_and_no_candidates():
    k, W = 21, 2
    rng = np.random.default_rng(5)
    mom, dad, staged, _ = _trio_inputs(rng, k, W)
    seed = jscore.seed_score_table(mom, dad, 1024)
    jacc, tacc = _accs(staged, np.zeros(len(staged), bool), 0)
    want = jfused.fused_call_full(jacc, seed, 0, 1)
    got = tfused.fused_call_full(tacc, _port_score(seed), 0, 1)
    _assert_same(got, want)
    assert len(got[0]) == 0 and got[5] == 0


def test_fused_call_more_candidates_than_jax_capacity():
    """More candidates than the JAX call's default static capacity K: JAX retries with a
    larger K, the port's output is dynamic. Both give the same rows."""
    k, W = 31, 2
    K = jfused.default_max_candidates(k)
    rng = np.random.default_rng(1)
    child_only = _rand_kmers(rng, K + 500, W, k)
    mom = _table(_rand_kmers(rng, 100, W, k), np.ones(100, int), 256)
    seed = jscore.seed_score_table(mom, mom, 512)
    staged = np.concatenate([child_only, child_only])
    jacc, tacc = _accs(staged, np.ones(len(staged), bool), len(staged))
    want = jfused.fused_call_full(jacc, seed, 0, 2)
    got = tfused.fused_call_full(tacc, _port_score(seed), 0, 2)
    _assert_same(got, want)
    assert len(got[0]) > K
