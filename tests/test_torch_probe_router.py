"""The port's mesh, collectives and sharded probe (denovo_kmer_tpu_torch/parallel/{mesh,
probe}.py) against the JAX package on the CPU: the tiled all_to_all over the table axis, psum
and the reads-axis all_gather against jax.lax's under shard_map on the forced 8 host devices;
make_mesh's shapes and its "needs N devices" refusal; bucketize on tests/test_sharded.py's
input; unbucketize_counts; both probe plans against make_sharded_probe and the single-device
probe_table, including the ring under skew (tests/test_probe_router.py). Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops.table import KmerTable as JaxTable
from denovo_kmer_tpu.ops.table import build_table as jax_build_table
from denovo_kmer_tpu.parallel import mesh as jmesh
from denovo_kmer_tpu.parallel import probe as jprobe
from denovo_kmer_tpu.parallel import router as jrouter
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.table import KmerTable, probe_table, table_from_numpy
from denovo_kmer_tpu_torch.parallel import mesh, probe, router

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def _shard_map(fn, shape, n_in=1):
    from jax import shard_map

    m = jmesh.make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
    spec = P(jmesh.AXIS_READS, jmesh.AXIS_TABLE)
    return jax.jit(shard_map(fn, mesh=m, in_specs=(spec,) * n_in, out_specs=spec))


def _grid(a):
    """(R, T, ...) numpy → per-shard torch tensors [r][t]."""
    return [[torch.from_numpy(np.ascontiguousarray(a[r, t]).astype(np.int64))
             for t in range(a.shape[1])] for r in range(a.shape[0])]


def _stack(g):
    return np.stack([np.stack([x.numpy() for x in row]) for row in g])


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_match_jax(shape):
    R, T = shape
    rng = np.random.default_rng(R * 10 + T)
    a = rng.integers(0, 1000, size=(R, T, T * 3, 2)).astype(np.int32)
    m = mesh.make_mesh(shape, device="cpu")

    def a2a(x):
        y = jax.lax.all_to_all(x[0, 0], jmesh.AXIS_TABLE, split_axis=0, concat_axis=0,
                               tiled=True)
        return y[None, None]

    want = np.asarray(_shard_map(a2a, shape)(jnp.asarray(a)))
    np.testing.assert_array_equal(_stack(mesh.all_to_all(m, _grid(a))), want)

    for axes in ((jmesh.AXIS_READS, jmesh.AXIS_TABLE), (jmesh.AXIS_TABLE,),
                 (jmesh.AXIS_READS,)):
        def ps(x, axes=axes):
            return jax.lax.psum(x, axes)

        want = np.asarray(_shard_map(ps, shape)(jnp.asarray(a)))
        np.testing.assert_array_equal(_stack(mesh.psum(m, _grid(a), axes)), want)

    def ag(x):
        return jax.lax.all_gather(x[0, 0], jmesh.AXIS_READS)[None, None]

    want = np.asarray(_shard_map(ag, shape)(jnp.asarray(a)))
    np.testing.assert_array_equal(_stack(mesh.all_gather(m, _grid(a))), want)


def test_make_mesh_shapes_and_refusal():
    m = mesh.make_mesh((2, 4), device="cpu")
    assert m.shape == {"reads": 2, "table": 4} and m.devices.shape == (2, 4)
    assert all(d == CPU for d in m.devices.flat)
    assert mesh.table_axis_ici_local(m)
    mesh.assert_table_axis_ici_local(m)
    # an explicit device list fills rows in order, and must hold R·T devices (JAX's message)
    devs = [torch.device("cpu")] * 8
    assert mesh.make_mesh((4, 2), devs).devices.shape == (4, 2)
    with pytest.raises(ValueError) as e:
        mesh.make_mesh((2, 2), [torch.device("cpu")])
    with pytest.raises(ValueError) as ej:
        jmesh.make_mesh((2, 2), jax.devices()[:1])
    assert str(e.value) == str(ej.value) == "mesh (2, 2) needs 4 devices, have 1"


def test_make_mesh_on_cuda_needs_a_card_per_shard(monkeypatch):
    """Without an explicit list a CUDA mesh takes the visible cards: --mesh 2x2 on a
    one-card host fails as the JAX package does on one device."""
    monkeypatch.setattr(mesh, "default_devices",
                        lambda device=None: [torch.device("cuda", 0)])
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) needs 4 devices, have 1"):
        mesh.make_mesh((2, 2))
    assert mesh.make_mesh((1, 1)).devices[0, 0] == torch.device("cuda", 0)
    assert mesh.make_mesh((2, 4), [torch.device("cuda", 0)] * 8).devices.shape == (2, 4)


def test_bucketize_matches_jax_on_the_sharded_test_input():
    """tests/test_sharded.py:40's input: N=512, W=2, T=4, 80% valid; then a capacity of 8."""
    rng = np.random.default_rng(2)
    N, W, T = 512, 2, 4
    kmers = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    valid = rng.random(N) < 0.8
    for cap in (router.route_capacity(N, T, 1.5), 8):
        want = jax.tree.map(np.asarray, jrouter.bucketize(jnp.asarray(kmers),
                                                          jnp.asarray(valid), T, cap))
        got = router.bucketize(torch.from_numpy(kmers.view(np.int32)), torch.from_numpy(valid),
                               T, cap)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert (int(got[3]) > 0) == (cap == 8)


def test_unbucketize_counts_matches_jax():
    rng = np.random.default_rng(5)
    N, W, T = 300, 2, 4
    q = rng.integers(0, 2**20, size=(N, W), dtype=np.uint32)
    valid = rng.random(N) < 0.9
    cap = 64  # some buckets overflow: their queries come back 0
    disp, mask, src, ovf = jrouter.bucketize(jnp.asarray(q), jnp.asarray(valid), T, cap)
    back = jnp.asarray(rng.integers(0, 9, size=(T, cap), dtype=np.uint32))
    want = np.asarray(jprobe.unbucketize_counts(back, mask, src, N))
    got = probe.unbucketize_counts(torch.from_numpy(np.asarray(back).astype(np.int64)),
                                   torch.from_numpy(np.array(mask)),
                                   torch.from_numpy(np.array(src)), N)
    assert int(ovf) > 0
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _sharded_tables(keys_np, counts_np, shape, shard_cap, W):
    """tests/test_probe_router.py's engine layout, for both packages."""
    R, T = shape
    owners = np.asarray(jrouter.owner_of(jnp.asarray(keys_np), T))
    keys = np.full((R, T, shard_cap, W), 0xFFFFFFFF, np.uint32)
    counts = np.zeros((R, T, shard_cap), np.uint32)
    ns = np.zeros((R, T), np.int32)
    for t in range(T):
        sel = owners == t
        k_t, c_t = keys_np[sel], counts_np[sel]
        order = np.lexsort(tuple(k_t[:, w] for w in range(W - 1, -1, -1)))
        n = len(k_t)
        keys[:, t, :n], counts[:, t, :n], ns[:, t] = k_t[order], c_t[order], n
    jm = jmesh.make_mesh(shape, jax.devices()[:R * T])

    def put(a, spec):
        return jax.device_put(a, NamedSharding(jm, spec))

    jt = JaxTable(keys=put(keys, P("reads", "table", None, None)),
                  counts=put(counts, P("reads", "table", None)), n=put(ns, P("reads", "table")))
    pt = [[table_from_numpy(keys[r, t], counts[r, t], ns[r, t], "cpu") for t in range(T)]
          for r in range(R)]
    return jm, jt, pt


def _both_probes(shape, plan, factor, keys, counts, queries, valid, shard_cap):
    W = keys.shape[1]
    jm, jt, pt = _sharded_tables(keys, counts, shape, shard_cap, W)
    qspec = NamedSharding(jm, P(("reads", "table")))
    jfn = jprobe.make_sharded_probe(jm, JaxConfig(k=21, table_capacity=4096,
                                                   route_capacity_factor=factor), plan=plan)
    jc, jo = jfn(jt, jax.device_put(queries, qspec), jax.device_put(valid, qspec))
    fn = probe.make_sharded_probe(mesh.make_mesh(shape, device="cpu"),
                                  EngineConfig(k=21, table_capacity=4096,
                                               route_capacity_factor=factor), plan=plan)
    c, o = fn(pt, torch.from_numpy(queries.astype(np.int64)), torch.from_numpy(valid))
    np.testing.assert_array_equal(c.numpy().astype(np.uint32), np.asarray(jc))
    assert int(o) == int(np.asarray(jo)[0])
    return c.numpy(), int(o)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)])
@pytest.mark.parametrize("plan", ["alltoall", "ring"])
def test_sharded_probe_matches_jax_and_probe_table(shape, plan):
    rng = np.random.default_rng(42)
    W, n_keys, n_queries = 2, 3000, 4096
    keys = rng.integers(0, 2**20, size=(n_keys, W), dtype=np.uint32)
    tab = jax_build_table(jnp.asarray(keys)[:, None, :], jnp.ones((n_keys, 1), bool), 4096)
    n_tab = int(tab.n)
    tk, tc = np.asarray(tab.keys)[:n_tab], np.asarray(tab.counts)[:n_tab]
    q_hit = keys[rng.integers(0, n_keys, n_queries // 2)]
    q_miss = rng.integers(2**20, 2**21, size=(n_queries - n_queries // 2, W), dtype=np.uint32)
    queries = np.concatenate([q_hit, q_miss]).astype(np.uint32)
    rng.shuffle(queries)
    valid = rng.random(n_queries) < 0.9
    got, ovf = _both_probes(shape, plan, 2.5, tk, tc, queries, valid, 2048)
    flat = table_from_numpy(np.asarray(tab.keys), np.asarray(tab.counts), n_tab, "cpu")
    want = probe_table(flat, torch.from_numpy(queries.astype(np.int64))).numpy()
    assert ovf == 0
    np.testing.assert_array_equal(got, np.where(valid, want, 0))


def test_ring_probe_exact_under_skew():
    """Every query owned by shard 3: all-to-all overflows at factor 1 (counted), the ring
    stays exact; both equal the JAX plans."""
    rng = np.random.default_rng(7)
    W, T = 2, 8
    pool = rng.integers(0, 2**22, size=(200_000, W), dtype=np.uint32)
    skewed = pool[np.asarray(jrouter.owner_of(jnp.asarray(pool), T)) == 3][:2048]
    assert len(skewed) == 2048
    tab = jax_build_table(jnp.asarray(skewed)[:, None, :], jnp.ones((2048, 1), bool), 4096)
    n_tab = int(tab.n)
    tk, tc = np.asarray(tab.keys)[:n_tab], np.asarray(tab.counts)[:n_tab]
    queries = skewed[rng.integers(0, len(skewed), 4096)].astype(np.uint32)
    valid = np.ones(4096, bool)
    _, ovf = _both_probes((1, 8), "alltoall", 1.0, tk, tc, queries, valid, 4096)
    assert ovf > 0
    got, ovf_r = _both_probes((1, 8), "ring", 1.0, tk, tc, queries, valid, 4096)
    flat = table_from_numpy(np.asarray(tab.keys), np.asarray(tab.counts), n_tab, "cpu")
    assert ovf_r == 0
    np.testing.assert_array_equal(
        got, probe_table(flat, torch.from_numpy(queries.astype(np.int64))).numpy())


def test_unknown_plan_raises():
    with pytest.raises(ValueError, match="unknown probe plan"):
        probe.make_sharded_probe(mesh.make_mesh((1, 2), device="cpu"), EngineConfig(),
                                 plan="gossip")
