"""The port's sorted joins and three-table trio call (denovo_kmer_tpu_torch/ops/join.py,
ops/trio.py) against the JAX package's join_tables_on_child, probe_table_sorted,
candidate_flags and call_candidates on the same numpy-seeded tables: W = 1..4 (k = 15, 21,
31, 33, 63, and k = 16 / 32 where a real k-mer equals the all-ones padding key), empty
tables, duplicated and absent queries, and overflowed tables (sticky n above capacity).
Tolerance 0: every quantity is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.ops import join as jjoin
from denovo_kmer_tpu.ops import trio as jtrio
from denovo_kmer_tpu.ops.table import KmerTable as JaxTable
from denovo_kmer_tpu_torch.ops import join, trio
from denovo_kmer_tpu_torch.ops.table import probe_table, table_from_numpy

torch.set_num_threads(1)

PAD = np.uint32(0xFFFFFFFF)


def _pool(rng, n, k):
    """n distinct (n, W) uint32 key rows of real k-mers, sorted; k with 2k % 32 == 0 gets
    the all-ones k-mer (equal to the padding key) among them."""
    W = -(-2 * k // 32)
    top = 2 * k - 32 * (W - 1)
    rows = rng.integers(0, 2**32, size=(n + 8, W), dtype=np.uint32)
    if top < 32:
        rows[:, 0] &= np.uint32((1 << top) - 1)
    else:
        rows[0] = PAD
    rows = np.unique(rows, axis=0)[:n]
    return rows[np.lexsort(tuple(rows[:, w] for w in range(W - 1, -1, -1)))]


def _table(rng, pool, frac, capacity, overflow=False):
    """A sorted table over a random subset of ``pool`` with counts in [1, 5]: (keys, counts,
    n) host arrays. ``overflow``: capacity rows of the subset and a sticky n = capacity + 1."""
    sel = np.sort(rng.choice(len(pool), int(len(pool) * frac), replace=False))
    keys = pool[sel][:capacity]
    n = len(keys)
    out_k = np.full((capacity, pool.shape[1]), PAD, np.uint32)
    out_c = np.zeros((capacity,), np.uint32)
    out_k[:n] = keys
    out_c[:n] = rng.integers(1, 6, size=n)
    return out_k, out_c, capacity + 1 if overflow else n


def _jax(t):
    k, c, n = t
    return JaxTable(jnp.asarray(k), jnp.asarray(c), jnp.asarray(n, jnp.int32))


def _port(t):
    return table_from_numpy(*t, "cpu")


CASES = [  # (k, pool size, (child, mom, dad) fractions, capacity, overflowed tables)
    (15, 300, (0.6, 0.5, 0.5), 256, ()),
    (21, 200, (0.7, 0.4, 0.6), 200, ()),
    (31, 500, (0.5, 0.6, 0.3), 512, ()),
    (33, 300, (0.6, 0.5, 0.5), 256, ()),
    (63, 300, (0.6, 0.5, 0.5), 256, ()),
    (16, 300, (0.9, 0.9, 0.9), 300, ()),
    (32, 300, (0.9, 0.9, 0.9), 300, ()),
    (31, 300, (0.0, 0.5, 0.5), 64, ()),  # empty child
    (31, 300, (0.6, 0.0, 0.0), 256, ()),  # empty parents
    (21, 400, (0.8, 0.8, 0.8), 128, ("child", "mom")),  # overflowed tables
]


def _trio_tables(case, seed):
    k, n_pool, fracs, cap, over = case
    rng = np.random.default_rng(seed)
    pool = _pool(rng, n_pool, k)
    return {name: _table(rng, pool, f, cap, name in over)
            for name, f in zip(("child", "mom", "dad"), fracs)}


@pytest.mark.parametrize("case", CASES)
def test_join_tables_on_child_matches_jax(case):
    t = _trio_tables(case, 1)
    want = jjoin.join_tables_on_child(_jax(t["child"]), _jax(t["mom"]), _jax(t["dad"]))
    got = join.join_tables_on_child(_port(t["child"]), _port(t["mom"]), _port(t["dad"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.asarray(w).dtype), np.asarray(w))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tau,minc", [(0, 2), (2, 1)])
def test_candidate_flags_and_call_candidates_match_jax(case, tau, minc):
    t = _trio_tables(case, 2)
    jt = [_jax(t[s]) for s in ("child", "mom", "dad")]
    pt = [_port(t[s]) for s in ("child", "mom", "dad")]
    for g, w in zip(trio.candidate_flags(*pt, tau, minc), jtrio.candidate_flags(*jt, tau, minc)):
        np.testing.assert_array_equal(g.numpy().astype(np.asarray(w).dtype), np.asarray(w))
    want = jtrio.call_candidates(*jt, tau, minc)
    got = trio.call_candidates(*pt, tau, minc)
    assert int(got.n) == int(want.n)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


@pytest.mark.parametrize("k", [15, 21, 31, 33, 63, 16, 32])
@pytest.mark.parametrize("shape", [(700,), (5, 60)])
def test_probe_table_sorted_matches_jax(k, shape):
    """Duplicated and absent queries in any order, in a (..., W) batch, on a partly filled
    table and on an empty one; equal to the JAX probe and to the port's binary search."""
    rng = np.random.default_rng(k)
    pool = _pool(rng, 600, k)
    for frac in (0.5, 0.0):
        tab = _table(rng, pool, frac, 512)
        q = pool[rng.integers(0, len(pool), size=int(np.prod(shape)))]
        q = q.reshape(*shape, pool.shape[1])
        want = np.asarray(jjoin.probe_table_sorted(_jax(tab), jnp.asarray(q)))
        qt = torch.from_numpy(q.astype(np.int64))
        got = join.probe_table_sorted(_port(tab), qt)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(got.numpy(), probe_table(_port(tab), qt).numpy())
        if frac:
            assert (want > 0).any() and (want == 0).any()
