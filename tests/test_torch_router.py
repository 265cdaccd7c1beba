"""The port's hash router (denovo_kmer_tpu_torch/parallel/router.py) against the JAX
package's: the same hashes, owners, passes, capacities and buckets on the same numpy-seeded
inputs. Tolerance 0: every quantity is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.parallel import router as jax_router
from denovo_kmer_tpu_torch.parallel import router

torch.set_num_threads(1)


def _words(W, n=4096, seed=0):
    rng = np.random.default_rng(seed * 10 + W)
    a = rng.integers(0, 2**32, size=(n, W), dtype=np.uint32)
    a[0] = 0
    a[1] = 0xFFFFFFFF
    a[2, ::2] = 0xFFFFFFFF
    return a


def _t(a):
    """uint32 host array → the port's int32 bit patterns."""
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_mix32_matches_jax(W):
    a = _words(W)
    for basis in (0x811C9DC5, 0x9E3779B9):
        want = np.asarray(jax_router.mix32(jnp.asarray(a), basis=basis))
        got = router.mix32(_t(a), basis=basis)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        # int64-carried values give the same hash as int32 bit patterns
        np.testing.assert_array_equal(
            router.mix32(torch.from_numpy(a.astype(np.int64)), basis=basis).numpy(), got.numpy())


def test_mix32_top_word_all_ones():
    """h = 0xFFFFFFFF through every multiply: the split products never overflow int64."""
    a = np.full((4, 2), 0xFFFFFFFF, np.uint32)
    a[1] = [0, 0xFFFFFFFF]
    h = torch.full((3,), 0xFFFFFFFF, dtype=torch.int64)
    for c in (0x01000193, 0x85EBCA6B, 0xC2B2AE35):
        assert router._mul32(h, c).tolist() == [(0xFFFFFFFF * c) & 0xFFFFFFFF] * 3
    want = np.asarray(jax_router.mix32(jnp.asarray(a)))
    np.testing.assert_array_equal(router.mix32(_t(a)).numpy().astype(np.uint32), want)


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("n", [2, 3, 7, 8])
def test_owner_and_pass_match_jax(W, n):
    a = _words(W, seed=n)
    np.testing.assert_array_equal(router.owner_of(_t(a), n).numpy(),
                                  np.asarray(jax_router.owner_of(jnp.asarray(a), n)))
    np.testing.assert_array_equal(router.pass_of(_t(a), n).numpy(),
                                  np.asarray(jax_router.pass_of(jnp.asarray(a), n)))


@pytest.mark.parametrize("n,shards,factor", [
    (0, 4, 1.25), (1, 1, 1.0), (1000, 3, 1.4), (34_078_720, 4, 1.4), (5632, 7, 0.1)])
def test_route_capacity_matches_jax(n, shards, factor):
    assert router.route_capacity(n, shards, factor) == \
        jax_router.route_capacity(n, shards, factor)


@pytest.mark.parametrize("T,cap,own,overflows", [
    (4, 150, None, True), (3, 64, "pass", True), (5, 1024, None, False)])
def test_bucketize_matches_jax(T, cap, own, overflows):
    a = _words(2, n=1000, seed=T)
    rng = np.random.default_rng(T)
    valid = rng.random(1000) < 0.8
    jo = to = None
    if own == "pass":
        jo = jax_router.pass_of(jnp.asarray(a), T).astype(jnp.int32)
        to = router.pass_of(_t(a), T)
    jd, jm, js, jovf = jax_router.bucketize(jnp.asarray(a), jnp.asarray(valid), T, cap,
                                            owner=jo)
    d, m, s, ovf = router.bucketize(_t(a), torch.from_numpy(valid), T, cap, owner=to)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(d.numpy().astype(np.uint32)[jm], np.asarray(jd)[jm])
    assert int(ovf) == int(jovf)
    assert (int(ovf) > 0) == overflows
