"""The port's sharded engine (denovo_kmer_tpu_torch/parallel/sharded_table.py) against the
JAX package's ShardedKmerEngine on the forced 8 host devices, both fed the same batches: the
finalized tables in engine layout (save_table's arrays and meta, loadable in both
directions), the scored child's tables and candidates, on meshes (2,4), (4,2), (1,8), (8,1);
the carry-risk input of tests/test_sharded.py:120, the mixed prefix and N batches of :228,
the candidate-capacity retry input of :191 and the even-k folded-union overflow of :287;
overlap on and off bit-identical (tests/test_overlap_route.py); sticky table overflow and
route overflow with JAX's messages; place_flat_table from a `count` checkpoint; the
three-table call. Tolerance 0: every quantity is an integer."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops.pack import pack_seqs as jax_pack_seqs
from denovo_kmer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from denovo_kmer_tpu.parallel.sharded_table import RouteOverflowError as JaxRouteOverflow
from denovo_kmer_tpu.parallel.sharded_table import ShardedKmerEngine as JaxEngine
from denovo_kmer_tpu.utils.checkpoint import save_table as jax_save_table
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops import score as tscore
from denovo_kmer_tpu_torch.ops import stream as tstream
from denovo_kmer_tpu_torch.ops import table as ttable
from denovo_kmer_tpu_torch.ops.pack import pack_seqs
from denovo_kmer_tpu_torch.ops.table import table_from_numpy
from denovo_kmer_tpu_torch.parallel import sharded_table as tsharded
from denovo_kmer_tpu_torch.parallel.mesh import make_mesh
from denovo_kmer_tpu_torch.parallel.sharded_table import RouteOverflowError, ShardedKmerEngine
from denovo_kmer_tpu_torch.utils.checkpoint import load_table

torch.set_num_threads(1)

CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13)
MESHES = [(2, 4), (4, 2), (1, 8), (8, 1)]


def _engines(shape, **kw):
    cfg = dict(CFG, mesh_shape=shape, **kw)
    jm = jax_make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
    return (JaxEngine(JaxConfig(**cfg), jm),
            ShardedKmerEngine(EngineConfig(**cfg), make_mesh(shape, device="cpu")))


def _seqs(seed, n, length=64, n_rate=0.0, genome=None):
    rng = np.random.default_rng(seed)
    if genome is not None:
        starts = rng.integers(0, len(genome) - length + 1, size=n)
        return [genome[s:s + length] for s in starts]
    base = np.frombuffer(b"ACGTN", dtype=np.uint8)
    probs = [(1 - n_rate) / 4] * 4 + [n_rate]
    return [bytes(base[rng.choice(5, length, p=probs)]).decode() for _ in range(n)]


def _batches(seqs_list, cfg):
    """The same batches for both packages, each packed by its own pack_seqs."""
    jb = [jax_pack_seqs(s, JaxConfig(**cfg), batch_size=cfg["batch_reads"]) for s in seqs_list]
    pb = [pack_seqs(s, EngineConfig(**cfg), batch_size=cfg["batch_reads"]) for s in seqs_list]
    return jb, pb


def _genome(seed, n=3000):
    rng = np.random.default_rng(seed)
    return bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]).decode()


def _build(engine, batches, ingest="ingest"):
    st = engine.new_build()
    for b in batches:
        st = getattr(engine, ingest)(st, b)
    return engine.finalize(st)


def _save_both(tmp_path, jeng, peng, jtab, ptab, name):
    """Both engines' save_table; → (jax path, port path)."""
    jp, pp = tmp_path / f"{name}.jax.npz", tmp_path / f"{name}.port.npz"
    jeng.save_table(str(jp), jtab, source=name)
    peng.save_table(str(pp), ptab, source=name)
    return jp, pp


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in ("keys", "counts", "n")}, json.loads(bytes(z["meta"]).decode())


def _assert_same_npz(a, b):
    (arr_a, meta_a), (arr_b, meta_b) = _npz(a), _npz(b)
    assert meta_a == meta_b
    for k in arr_a:
        assert arr_a[k].dtype == arr_b[k].dtype, k
        np.testing.assert_array_equal(arr_a[k], arr_b[k], err_msg=k)


@pytest.mark.parametrize("shape", MESHES)
def test_engine_tables_and_call_match_jax(shape, tmp_path, monkeypatch):
    """Parents over several windows (accum 2, 5 batches), the seeded child, the fused call
    and the compacting finalize_score + call_score; the tables saved by both packages hold
    the same arrays and meta, and each package loads the other's file. The port's window
    folds and finalizes merge (``ops/table._merge_sorted``) and never sort a table
    (``_aggregate_parts``)."""
    merges, sorts = [], []

    def counted(calls, real):
        def wrapped(*a, **k):
            calls.append(1)
            return real(*a, **k)
        return wrapped

    for mod in (ttable, tstream, tscore, tsharded):
        monkeypatch.setattr(mod, "_merge_sorted", counted(merges, mod._merge_sorted))
    monkeypatch.setattr(ttable, "_aggregate_parts", counted(sorts, ttable._aggregate_parts))
    # windows of 2 batches of 8-64 reads a shard: a wide route capacity
    jeng, peng = _engines(shape, accum_batches=2, route_capacity_factor=4.0)
    cfg = dict(CFG, accum_batches=2, route_capacity_factor=4.0, mesh_shape=shape)
    g = _genome(1)
    jmom_b, pmom_b = _batches([_seqs(10 + i, 64, genome=g) for i in range(5)], cfg)
    jdad_b, pdad_b = _batches([_seqs(20 + i, 64, genome=g) for i in range(5)], cfg)
    jch_b, pch_b = _batches([_seqs(30 + i, 64, genome=_genome(2)) for i in range(3)]
                            + [_seqs(40 + i, 64, genome=g) for i in range(2)], cfg)
    jmom, pmom = _build(jeng, jmom_b), _build(peng, pmom_b)
    jdad, pdad = _build(jeng, jdad_b), _build(peng, pdad_b)
    for name, jt, pt in (("mom", jmom, pmom), ("dad", jdad, pdad)):
        jp, pp = _save_both(tmp_path, jeng, peng, jt, pt, name)
        _assert_same_npz(jp, pp)
        assert peng.total_unique(pt) == jeng.total_unique(jt)
        # both directions: the JAX file loads in the port, the port's file in JAX
        pk, pc, pn = peng.table_arrays(peng.load_table(str(jp)))
        np.testing.assert_array_equal(pk, np.asarray(jt.keys)[0])
        np.testing.assert_array_equal(pn, np.asarray(jt.n)[0])
        back = jeng.load_table(str(pp))
        np.testing.assert_array_equal(np.asarray(back.keys), np.asarray(jt.keys))
        np.testing.assert_array_equal(np.asarray(back.counts), np.asarray(jt.counts))

    def scored(eng, mom, dad, batches):
        st = eng.new_score_build(mom, dad)
        for b in batches:
            st = eng.ingest_score(st, b)
        return st

    want = jeng.finalize_call_score(scored(jeng, jmom, jdad, jch_b))
    got = peng.finalize_call_score(scored(peng, pmom, pdad, pch_b))
    assert got == want
    assert want[0], "the trio should have candidates"
    jstab = jeng.finalize_score(scored(jeng, jmom, jdad, jch_b))
    pstab = peng.finalize_score(scored(peng, pmom, pdad, pch_b))
    for leaf in ("keys", "counts", "pcounts", "n"):
        want_leaf = np.asarray(getattr(jstab, leaf))
        got_leaf = np.stack([np.stack([getattr(t, leaf).numpy() for t in row])
                             for row in pstab])
        np.testing.assert_array_equal(got_leaf.astype(want_leaf.dtype), want_leaf)
    assert peng.call_score(pstab) == jeng.call_score(jstab) == want[0]
    # the three-table call (ops/trio.call_candidates a shard) on the finalized child table
    jchild, pchild = _build(jeng, jch_b), _build(peng, pch_b)
    assert peng.call(pchild, pmom, pdad) == jeng.call(jchild, jmom, jdad) == want[0]
    assert merges and not sorts


def _scored_twice(eng, mom, dad, batch):
    st = eng.new_score_build(mom, dad)
    st = eng.ingest_score(st, batch)  # twice: child counts reach
    return eng.ingest_score(st, batch)  # min_child_count=2


def test_carry_risk_input_matches_jax(monkeypatch):
    """tests/test_sharded.py:120: one carried count of 2^30 on a (2,4) mesh, above v5's
    per-row clamp (2^31-1)//2 — JAX reruns through v4; the port's exact group sums give the
    same candidates, the huge count among them."""
    jeng, peng = _engines((2, 4))
    jb, pb = _batches([_seqs(7, 64)], dict(CFG, mesh_shape=(2, 4)))
    jempty, pempty = _build(jeng, []), _build(peng, [])
    jst = _scored_twice(jeng, jempty, jempty, jb[0])
    acc, table, ovf = jeng._flush_score(jst.acc, jst.table, jst.ovf)
    counts = np.array(table.counts)
    ns = np.asarray(table.n)
    t = int(np.argmax(ns[0] > 0))
    counts[0, t, 0] = np.uint32(1 << 30)
    table = type(table)(keys=table.keys, pcounts=table.pcounts, n=table.n,
                        counts=jax.device_put(counts, table.counts.sharding))
    jst = type(jst)(acc=acc, ovf=ovf, table=table, pending=0)
    monkeypatch.setenv("DENOVO_FUSED_VARIANT", "v5")
    want = jeng.finalize_call_score(jst)

    pst = peng.flush_score(_scored_twice(peng, pempty, pempty, pb[0]))
    assert int(pst.table[0][t].n) == int(ns[0, t])
    pst.table[0][t].counts[0] = 1 << 30
    got = peng.finalize_call_score(pst)
    assert got == want
    assert any(c[1] >= 1 << 30 for c in got[0])


def test_candidate_capacity_retry_input_matches_jax():
    """tests/test_sharded.py:191: empty parents, every child k-mer a candidate, JAX's
    capacity K forced to 16 a shard (it retries with a larger K); the port has no K."""
    jeng, peng = _engines((1, 8))
    jb, pb = _batches([_seqs(7, 64)], dict(CFG, mesh_shape=(1, 8)))
    jempty, pempty = _build(jeng, []), _build(peng, [])
    jeng.fused_call_K = 16
    want = jeng.finalize_call_score(_scored_twice(jeng, jempty, jempty, jb[0]))
    got = peng.finalize_call_score(_scored_twice(peng, pempty, pempty, pb[0]))
    assert got == want and len(got[0]) > 8 * 16


def test_mixed_prefix_and_n_batches_match_jax():
    """tests/test_sharded.py:228: length-shipped (clean) and vwords (N-holding) batches in
    one stream give JAX's candidates."""
    cfg = dict(CFG, mesh_shape=(2, 4))
    jeng, peng = _engines((2, 4))
    jb, pb = _batches([_seqs(1, 64), _seqs(2, 64, n_rate=0.05)], cfg)
    assert pb[0].prefix_valid and not pb[1].prefix_valid
    results = []
    for eng, (clean, dirty) in ((jeng, jb), (peng, pb)):
        empty = _build(eng, [])
        st = eng.new_score_build(empty, empty)
        for _ in range(2):
            st = eng.ingest_score(st, clean)
            st = eng.ingest_score(st, dirty)
        results.append(eng.finalize_call_score(st))
    assert results[0] == results[1] and results[0][0]


def test_even_k_folded_union_overflow_raises_as_jax_does():
    """tests/test_sharded.py:287: k=16 (the compacting fallback), 8 rows a shard; every row
    partial may fit, the folded union cannot: both packages raise the same message."""
    cfg = dict(CFG, k=16, table_capacity=64, mesh_shape=(2, 4))
    jm = jax_make_mesh((2, 4), jax.devices()[:8])
    jeng = JaxEngine(JaxConfig(**cfg), jm)
    peng = ShardedKmerEngine(EngineConfig(**cfg), make_mesh((2, 4), device="cpu"))
    jb, pb = _batches([_seqs(1, 64), _seqs(2, 64)], cfg)
    msgs = []
    for eng, batches in ((jeng, jb), (peng, pb)):
        empty = _build(eng, [])
        st = eng.new_score_build(empty, empty)
        for b in batches:
            st = eng.ingest_score(st, b)
        with pytest.raises(RuntimeError, match="overflow") as e:
            eng.finalize_call_score(st)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("shape", [(2, 4)])
def test_overlap_on_and_off_are_bit_identical(shape):
    """tests/test_overlap_route.py: 5 batches over a 2-batch window, with and without the
    route on the next ingest; the same tables and candidates, and JAX's."""
    cfg = dict(CFG, table_capacity=1 << 15, accum_batches=2, mesh_shape=shape)
    jm = jax_make_mesh(shape, jax.devices()[:8])
    jeng = JaxEngine(JaxConfig(**cfg), jm)
    sets = [_batches([_seqs(s * 10 + i, 64, genome=_genome(s)) for i in range(5)], cfg)
            for s in (1, 2, 3)]

    def trio(eng, which):
        mom, dad = _build(eng, sets[0][which]), _build(eng, sets[1][which])
        st = eng.new_score_build(mom, dad)
        for b in sets[2][which]:
            st = eng.ingest_score(st, b)
        tabs = [np.stack([np.stack([t.keys.numpy() for t in row]) for row in tab])
                if isinstance(tab, list) else np.asarray(tab.keys) for tab in (mom, dad)]
        return tabs, eng.finalize_call_score(st)

    out = {}
    for overlap in (True, False):
        peng = ShardedKmerEngine(EngineConfig(**cfg), make_mesh(shape, device="cpu"),
                                 overlap_route=overlap)
        out[overlap] = trio(peng, 1)
    jtabs, jres = trio(jeng, 0)
    for a, b, c in zip(out[True][0], out[False][0], jtabs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a.astype(np.uint32), c)
    assert out[True][1] == out[False][1] == jres
    assert jres[0], "the trio should have candidates"


def test_sticky_table_overflow_raises_jax_message():
    """A shard that overflowed in an early window stays overflowed through later windows
    and the finalize: both packages raise the same message (the same sticky n). At R = 4
    the finalize's first merges overflow too, and its n is still the union's size."""
    for shape in ((2, 2), (4, 1)):
        cfg = dict(CFG, table_capacity=256, accum_batches=1, mesh_shape=shape)
        jeng = JaxEngine(JaxConfig(**cfg), jax_make_mesh(shape, jax.devices()[:4]))
        peng = ShardedKmerEngine(EngineConfig(**cfg), make_mesh(shape, device="cpu"))
        jb, pb = _batches([_seqs(i, 64) for i in range(3)], cfg)
        msgs = []
        for eng, batches in ((jeng, jb), (peng, pb)):
            with pytest.raises(RuntimeError, match="table shard overflow") as e:
                _build(eng, batches)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], shape


def test_route_overflow_raises_jax_message():
    cfg = dict(CFG, route_capacity_factor=0.05, mesh_shape=(1, 8))
    jeng = JaxEngine(JaxConfig(**cfg), jax_make_mesh((1, 8), jax.devices()[:8]))
    peng = ShardedKmerEngine(EngineConfig(**cfg), make_mesh((1, 8), device="cpu"))
    jb, pb = _batches([_seqs(i, 64) for i in range(2)], cfg)
    with pytest.raises(JaxRouteOverflow) as ej:
        _build(jeng, jb)
    with pytest.raises(RouteOverflowError) as ep:
        _build(peng, pb)
    assert str(ep.value) == str(ej.value)


def test_place_flat_table_from_a_count_checkpoint(tmp_path):
    """A `count` .npz (written by the JAX package) hash-partitioned onto the mesh: the same
    engine-layout arrays as JAX's place_flat_table; an unknown backend is refused."""
    from denovo_kmer_tpu.ops.table import build_table

    jeng, peng = _engines((2, 4))
    rng = np.random.default_rng(4)
    kmers = rng.integers(0, 2**20, size=(3000, 2), dtype=np.uint32)
    flat = build_table(jnp.asarray(kmers), jnp.ones((3000,), bool), CFG["table_capacity"])
    path = str(tmp_path / "mom.npz")
    jax_save_table(path, flat, JaxConfig(**CFG), source="mom")
    jt = jeng.place_flat_table(flat)
    pt = peng.place_flat_table(load_table(path, EngineConfig(**CFG), device="cpu"))
    jp, pp = _save_both(tmp_path, jeng, peng, jt, pt, "placed")
    _assert_same_npz(jp, pp)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        peng.save_table(str(tmp_path / "x"), pt, backend="zarr")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        peng.load_table(pp, backend="zarr")
    # a flat table with more keys of one shard than the shard holds is refused
    small = ShardedKmerEngine(EngineConfig(**dict(CFG, table_capacity=256)),
                              make_mesh((1, 2), device="cpu"))
    big = table_from_numpy(np.asarray(flat.keys), np.asarray(flat.counts), int(flat.n),
                           "cpu")
    with pytest.raises(RuntimeError, match="raise --table-capacity"):
        small.place_flat_table(big)


def test_batch_split_must_divide():
    with pytest.raises(ValueError, match="divisible by mesh size 3"):
        ShardedKmerEngine(EngineConfig(**CFG), make_mesh((1, 3), device="cpu"))
