"""The port's per-block partition (denovo_kmer_tpu_torch/ops/partition.py) against the JAX
Pallas kernel ``radix_partition_blocks`` in interpret mode, at tests/test_partition_pallas.py's
cases: rows bucket-major and stable within each block, counts per block. On the CPU the port
runs the kernel's plain version; the CUDA kernel is held against that plain version on the
card by chip_smoke.py. Tolerance 0: every quantity is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.ops.partition_pallas import radix_partition_blocks as jax_partition
from denovo_kmer_tpu_torch.ops import partition
from denovo_kmer_tpu_torch.ops.partition import (
    MAX_SPILL_BUCKETS,
    partition_blocks_plain,
    partition_spill_blocks,
    radix_partition_blocks,
)

torch.set_num_threads(1)


def _case(n_buckets, block, C=4, G=3, seed=None):
    rng = np.random.default_rng(n_buckets * 1000 + block if seed is None else seed)
    N = block * G
    data = rng.integers(0, 2**32, size=(C, N), dtype=np.uint32)
    ids = rng.integers(0, n_buckets, size=N).astype(np.uint32)
    data[C - 1] = ids
    data[0] = np.arange(N, dtype=np.uint32)  # unique tags: order within a bucket shows
    return data, ids


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _check_against_jax(data, ids, n_buckets, block):
    want, want_counts = jax_partition(jnp.asarray(data), jnp.asarray(ids), n_buckets,
                                      block_lanes=block, interpret=True)
    out, counts = radix_partition_blocks(_t(data), _t(ids), n_buckets, block_lanes=block)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(want))
    return out, counts


@pytest.mark.parametrize("n_buckets,block", [(2, 256), (8, 512), (16, 1024)])
def test_partition_matches_jax_kernel(n_buckets, block):
    data, ids = _case(n_buckets, block)
    _check_against_jax(data, ids, n_buckets, block)


def test_partition_skewed_ids_match_jax_kernel():
    """All-one-bucket and empty-bucket extremes."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**32, size=(3, 512), dtype=np.uint32)
    ids = np.zeros(512, np.uint32)
    ids[300:] = 3
    out, counts = _check_against_jax(data, ids, 4, 256)
    assert counts.tolist() == [[256, 0, 0, 0], [44, 0, 0, 212]]


@pytest.mark.parametrize("shape,n_buckets,block,match", [
    ((2, 300), 4, 256, "block_lanes"),
    ((2, 256), 3, 256, "power of two"),
    ((2, 256), 256, 256, "> 128"),
])
def test_partition_rejects_what_jax_rejects(shape, n_buckets, block, match):
    data = np.zeros(shape, np.uint32)
    ids = np.zeros(shape[1], np.uint32)
    with pytest.raises(ValueError, match=match):
        jax_partition(jnp.asarray(data), jnp.asarray(ids), n_buckets, block_lanes=block,
                      interpret=True)
    with pytest.raises(ValueError, match=match):
        radix_partition_blocks(_t(data), _t(ids), n_buckets, block_lanes=block)


def test_strided_view_equals_contiguous():
    """(N, C).T — the spill's (W, S) view of its (S, W) staging rows — needs no copy."""
    data, ids = _case(8, 512, C=2)
    rows = _t(data.T)  # (N, C) contiguous
    view = rows.T
    assert not view.is_contiguous()
    a = radix_partition_blocks(view, _t(ids), 8, block_lanes=512)
    b = radix_partition_blocks(_t(data), _t(ids), 8, block_lanes=512)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _np_reference(data, ids, n_buckets, block):
    """tests/test_partition_pallas.py's numpy reference, with a ragged last block."""
    C, N = data.shape
    out = np.empty_like(data)
    G = -(-N // block)
    counts = np.zeros((G, n_buckets), np.int32)
    for g in range(G):
        sl = slice(g * block, min(N, (g + 1) * block))
        order = np.argsort(ids[sl], kind="stable")
        out[:, sl] = data[:, sl][:, order]
        counts[g] = np.bincount(ids[sl], minlength=n_buckets)
    return out, counts


@pytest.mark.parametrize("N", [5 * 256, 5 * 256 - 77, 100])
def test_spill_entry_five_buckets(N):
    """The spill's entry: n_passes + 1 = 5 buckets (not a power of two), ragged blocks."""
    rng = np.random.default_rng(N)
    data = rng.integers(0, 2**32, size=(2, N), dtype=np.uint32)
    ids = rng.integers(0, 5, size=N).astype(np.uint32)
    want, want_counts = _np_reference(data, ids, 5, 256)
    out, counts = partition_spill_blocks(_t(data.T).T, _t(ids), 5, block_lanes=256)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_spill_entry_bucket_limit():
    data = torch.zeros((2, 64), dtype=torch.int32)
    ids = torch.zeros(64, dtype=torch.int32)
    partition_spill_blocks(data, ids, MAX_SPILL_BUCKETS, block_lanes=32)
    with pytest.raises(ValueError, match="at most 1023 passes"):
        partition_spill_blocks(data, ids, MAX_SPILL_BUCKETS + 1, block_lanes=32)


def test_plain_version_and_cpu_dispatch():
    """CPU tensors take the plain version and leave the kernel's launch count alone."""
    data, ids = _case(16, 128, C=3, G=4, seed=7)
    before = partition.partition_kernel.launches
    got = radix_partition_blocks(_t(data), _t(ids), 16, block_lanes=128)
    plain = partition_blocks_plain(_t(data), _t(ids), 16, 128)
    assert all(torch.equal(x, y) for x, y in zip(got, plain))
    assert partition.partition_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        partition.partition_kernel(_t(data), _t(ids), 16, 128)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check on the H100)")
    data, ids = _case(5, 256, C=2, G=7, seed=3)
    d, i = _t(data).cuda(), _t(ids).cuda()
    got = partition_spill_blocks(d, i, 5, block_lanes=256)
    want = partition_blocks_plain(d, i, 5, 256)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_buckets", [1, 2, 5, 33, 1024])
def test_kernel_edges_match_plain_on_the_card(n_buckets):
    """N below one block and 3 blocks + 1 row, 1, 2, 4, 5 and 8 columns (more than 4 go
    through the kernel's tile 4 at a time), blocks of 2^17 rows whose ids do not fit shared
    memory, the strided (N, C).T view and a contiguous (C, N) input, all ids in one bucket
    and ids past the last bucket: rows and counts bit-exact against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on the H100)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n_buckets)
    shapes = [(N, 32768, C) for N in (1000, 3 * 32768 + 1) for C in (1, 2, 4, 5, 8)]
    shapes += [(2 * (1 << 17) + 5, 1 << 17, C) for C in (1, 2, 4, 5)]
    for N, lanes, C in shapes:
        rows = _t(rng.integers(0, 2**32, size=(N, C), dtype=np.uint32)).to(dev)
        for ids in (rng.integers(0, n_buckets, size=N),
                    np.full(N, n_buckets - 1),
                    rng.integers(0, n_buckets + 3, size=N)):
            i = _t(ids.astype(np.uint32)).to(dev)
            for data in (rows.T, rows.T.contiguous()):
                got = partition_spill_blocks(data, i, n_buckets, lanes)
                want = partition_blocks_plain(data, i, n_buckets, lanes)
                assert all(torch.equal(x, y) for x, y in zip(got, want)), (N, lanes, C)
