"""The port's block sort (denovo_kmer_tpu_torch/ops/block_sort.py) against the Pallas kernel
of benchmarks/micro_pallas_sort.py (``_kernel``) in interpret mode, one block at a time as
that script's MICRO_CHECK runs it: keys and payloads bit for bit, ties included. On the CPU
the port runs the kernel's plain version; the CUDA kernel is held against that plain version
on the card by chip_smoke.py and by the ``cuda``-marked test here. Tolerance 0."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from denovo_kmer_tpu_torch.ops.block_sort import (
    MAX_BLOCK_ROWS,
    block_sort,
    block_sort_plain,
    kernel_resources,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def micro():
    spec = importlib.util.spec_from_file_location(
        "micro_pallas_sort", os.path.join(ROOT, "benchmarks", "micro_pallas_sort.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_block_sort(micro, keys, pays, R):
    """The TPU kernel, interpret mode, on each (R, L) block in turn."""
    N, L = keys.shape
    call = pl.pallas_call(micro._kernel,
                          out_shape=(jax.ShapeDtypeStruct((R, L), jnp.uint32),) * 2,
                          interpret=True)
    outs = [call(jnp.asarray(keys[g:g + R]), jnp.asarray(pays[g:g + R]))
            for g in range(0, N, R)]
    return (np.concatenate([np.asarray(k) for k, _ in outs]),
            np.concatenate([np.asarray(p) for _, p in outs]))


#: every block height the kernel has an instance for
_HEIGHTS = [1 << i for i in range(1, 15)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _inputs(R, L, blocks, seed, key_range):
    rng = np.random.default_rng(seed)
    lo, hi = key_range
    keys = rng.integers(lo, hi, size=(R * blocks, L), dtype=np.uint64).astype(np.uint32)
    # unique payload tags, so the order of equal keys shows
    pays = np.arange(R * blocks * L, dtype=np.uint32).reshape(R * blocks, L)
    return keys, pays


@pytest.mark.parametrize("R,L,blocks,key_range", [
    (2, 1, 3, (0, 2**32)),
    (2, 3, 2, (0, 4)),
    (64, 3, 2, (0, 2**32)),
    (64, 128, 1, (0, 8)),            # many ties
    (64, 1, 2, (2**31, 2**32)),      # keys >= 2^31: the unsigned compare
    (256, 128, 1, (2**31 - 4, 2**31 + 4)),  # ties straddling the sign bit
    (2048, 3, 1, (0, 2**32)),        # the probe's block height
    (2048, 1, 1, (0, 16)),
    # the kernel's instance heights: registers only (4-32 rows), shuffles (128, 512), and
    # shared-memory transposes (4096); one column, and 9 (not a multiple of a CTA's columns)
    (4, 1, 5, (0, 2**32)),
    (4, 9, 3, (2**31 - 2, 2**31 + 2)),
    (8, 1, 4, (0, 4)),
    (8, 9, 2, (0, 2**32)),
    (16, 1, 3, (2**31 - 4, 2**31 + 4)),
    (16, 9, 2, (0, 8)),
    (32, 1, 3, (0, 2**32)),
    (32, 9, 2, (0, 4)),
    (128, 1, 2, (0, 8)),
    (128, 9, 2, (2**31 - 8, 2**31 + 8)),
    (512, 1, 2, (2**31, 2**32)),
    (512, 9, 1, (0, 16)),
    (4096, 1, 1, (2**31 - 8, 2**31 + 8)),
    (4096, 9, 1, (0, 2**32)),
])
def test_plain_matches_the_pallas_kernel(micro, R, L, blocks, key_range):
    keys, pays = _inputs(R, L, blocks, seed=R * 7 + L, key_range=key_range)
    want_k, want_p = _jax_block_sort(micro, keys, pays, R)
    got_k, got_p = block_sort(_t(keys), _t(pays), R)
    np.testing.assert_array_equal(got_k.numpy().view(np.uint32), want_k)
    np.testing.assert_array_equal(got_p.numpy().view(np.uint32), want_p)
    # every column of every block ascends, and each (key, payload) pair survives
    blocks_k = got_k.numpy().view(np.uint32).reshape(blocks, R, L)
    assert (np.diff(blocks_k.astype(np.int64), axis=1) >= 0).all()
    assert sorted(zip(keys.ravel(), pays.ravel())) == sorted(zip(want_k.ravel(),
                                                                 want_p.ravel()))


def test_plain_at_the_probe_block_shape_matches_the_pallas_kernel(micro):
    """One full (2048, 128) block, the shape of the TPU kernel's BlockSpec."""
    keys, pays = _inputs(2048, 128, 1, seed=5, key_range=(0, 2**32))
    want_k, want_p = _jax_block_sort(micro, keys, pays, 2048)
    got_k, got_p = block_sort_plain(_t(keys), _t(pays), 2048)
    np.testing.assert_array_equal(got_k.numpy().view(np.uint32), want_k)
    np.testing.assert_array_equal(got_p.numpy().view(np.uint32), want_p)


@pytest.mark.parametrize("bad,match", [
    (dict(keys=torch.zeros((8, 2), dtype=torch.int64)), "int32"),
    (dict(keys=torch.zeros((8,), dtype=torch.int32), pays=torch.zeros((8,), dtype=torch.int32)),
     r"\(N, L\)"),
    (dict(pays=torch.zeros((8, 3), dtype=torch.int32)), "differ"),
    (dict(keys=torch.zeros((2, 8), dtype=torch.int32).T), "contiguous"),
    (dict(block_rows=3), "power of two"),
    (dict(block_rows=16), "multiple"),
    (dict(block_rows=1), "power of two"),
    (dict(block_rows=32768), "16384"),
])
def test_wrapper_rejects_bad_inputs(bad, match):
    args = dict(keys=torch.zeros((8, 2), dtype=torch.int32),
                pays=torch.zeros((8, 2), dtype=torch.int32), block_rows=4)
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        block_sort(**args)


def test_lanes_keep_the_tile_in_shared_memory():
    """The wrapper takes every block height the kernel has an instance for, and no taller
    one (a column lives in the registers of one CTA's team), on either device."""
    assert MAX_BLOCK_ROWS == 16384
    keys = torch.zeros((MAX_BLOCK_ROWS, 1), dtype=torch.int32)
    got_k, got_p = block_sort(keys, keys + 1, MAX_BLOCK_ROWS)
    assert torch.equal(got_k, keys) and torch.equal(got_p, keys + 1)
    tall = torch.zeros((2 * MAX_BLOCK_ROWS, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two from 2 to 16384"):
        block_sort(tall, tall, 2 * MAX_BLOCK_ROWS)


@pytest.mark.parametrize("R", _HEIGHTS)
def test_plain_sorts_unique_keys_at_every_instance_height(R):
    """At every height the kernel has an instance for (the interpret-mode Pallas kernel is
    too slow above 4,096 rows): with distinct keys the network's output is the sorted
    column, each payload with its key, whatever the order of ties would be."""
    L, blocks = 2, 2
    rng = np.random.default_rng(R)
    # an odd multiplier maps 0 .. n-1 to n distinct words spread over the whole range
    spread = np.arange(R * blocks, dtype=np.uint64) * 0x9E3779B1
    keys = np.stack([rng.permutation((spread + int(rng.integers(2**32))) % 2**32)
                     .astype(np.uint32) for _ in range(L)], axis=1)
    pays = np.arange(R * blocks * L, dtype=np.uint32).reshape(R * blocks, L)
    got_k, got_p = block_sort(_t(keys), _t(pays), R)
    order = np.argsort(keys.reshape(blocks, R, L), axis=1, kind="stable")
    want_k = np.take_along_axis(keys.reshape(blocks, R, L), order, axis=1).reshape(-1, L)
    want_p = np.take_along_axis(pays.reshape(blocks, R, L), order, axis=1).reshape(-1, L)
    np.testing.assert_array_equal(got_k.numpy().view(np.uint32), want_k)
    np.testing.assert_array_equal(got_p.numpy().view(np.uint32), want_p)


_CARD_GRID = [(R, L) for R in _HEIGHTS for L in (1, 3, 9, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,L", _CARD_GRID)
def test_kernel_matches_plain_on_the_card(R, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check on the H100)")
    key_range = [(0, 2**32), (0, 8), (2**31 - 4, 2**31 + 4)][(R + L) % 3]
    keys, pays = _inputs(R, L, 4, seed=R + L, key_range=key_range)
    k, p = _t(keys).cuda(), _t(pays).cuda()
    before = block_sort.launches
    got = block_sort(k, p, R)
    want = block_sort_plain(k, p, R)
    assert block_sort.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("R", _HEIGHTS)
def test_kernel_geometry_on_the_card(R):
    """The entry's CTA at each height, as the CUDA runtime reports it: 512 threads, a tile
    in shared memory, and two CTAs an SM at the probe's height."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py prints these resources on the H100)")
    res = kernel_resources(torch.zeros((R, 1), dtype=torch.int32, device="cuda"), R)
    # 16 rows a thread, the whole block below 16 rows and 32 at the tallest
    assert res["threads"] == 512
    assert res["columns"] * R // 512 == (32 if R == MAX_BLOCK_ROWS else min(R, 16))
    assert res["smem_bytes"] == 8 * res["columns"] * R <= 227 * 1024
    assert res["ctas_per_sm"] >= (2 if R == 2048 else 1)
