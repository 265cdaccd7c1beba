"""The port's orbax table directory (denovo_kmer_tpu_torch/utils/checkpoint_orbax.py, written
and read through tensorstore alone) against the JAX package's orbax checkpoints
(tests/test_checkpoint_orbax.py's inputs): the port writes and JAX's load_table_orbax and
ShardedKmerEngine.load_table(backend="orbax") read; JAX writes and the port reads; the
semantics-hash guard both ways; the ImportError without tensorstore. Tolerance 0."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("tensorstore")

from denovo_kmer_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from denovo_kmer_tpu.ops.pack import pack_seqs as jax_pack_seqs  # noqa: E402
from denovo_kmer_tpu.ops.table import build_table as jax_build_table  # noqa: E402
from denovo_kmer_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from denovo_kmer_tpu.parallel.sharded_table import ShardedKmerEngine as JaxEngine  # noqa: E402
from denovo_kmer_tpu.utils.checkpoint import CheckpointError as JaxCheckpointError  # noqa: E402
from denovo_kmer_tpu.utils.checkpoint_orbax import load_table_orbax as jax_load  # noqa: E402
from denovo_kmer_tpu.utils.checkpoint_orbax import save_table_orbax as jax_save  # noqa: E402
from denovo_kmer_tpu_torch.config import EngineConfig  # noqa: E402
from denovo_kmer_tpu_torch.ops.pack import pack_seqs  # noqa: E402
from denovo_kmer_tpu_torch.ops.table import table_from_numpy, table_to_numpy  # noqa: E402
from denovo_kmer_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from denovo_kmer_tpu_torch.parallel.sharded_table import ShardedKmerEngine  # noqa: E402
from denovo_kmer_tpu_torch.utils import checkpoint_orbax  # noqa: E402
from denovo_kmer_tpu_torch.utils.checkpoint import CheckpointError  # noqa: E402

CFG = dict(k=21, table_capacity=1 << 12)
MESH_CFG = dict(CFG, mesh_shape=(2, 4), batch_reads=64)


def _jax_table(seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**20, size=(500, 2), dtype=np.uint32)
    return jax_build_table(jnp.asarray(keys)[:, None, :], jnp.ones((500, 1), bool), 4096)


def _port_table(seed=0):
    tab = _jax_table(seed)
    return table_from_numpy(np.asarray(tab.keys), np.asarray(tab.counts), int(tab.n),
                            "cpu")


def _engines(seed):
    """The JAX and the port engine on a 2x4 mesh, each with the same finalized table."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(64)]
    je = JaxEngine(JaxConfig(**MESH_CFG), jax_make_mesh((2, 4), jax.devices()[:8]))
    pe = ShardedKmerEngine(EngineConfig(**MESH_CFG), make_mesh((2, 4), device="cpu"))
    jt = je.finalize(je.ingest(je.new_build(), jax_pack_seqs(seqs, je.cfg, batch_size=64)))
    pt = pe.finalize(pe.ingest(pe.new_build(), pack_seqs(seqs, pe.cfg, batch_size=64)))
    return je, jt, pe, pt


def _meta(path):
    with open(os.path.join(path, "denovo_kmer_meta.json")) as f:
        return json.load(f)


def test_port_writes_jax_reads_single_device(tmp_path):
    p = str(tmp_path / "tab.orbax")
    checkpoint_orbax.save_table_orbax(p, _port_table(0), EngineConfig(**CFG), source="test")
    got = jax_load(p, JaxConfig(**CFG))
    ref = _jax_table(0)
    assert int(got.n) == int(ref.n)
    np.testing.assert_array_equal(np.asarray(got.keys), np.asarray(ref.keys))
    np.testing.assert_array_equal(np.asarray(got.counts), np.asarray(ref.counts))
    assert np.asarray(got.keys).dtype == np.uint32 and np.asarray(got.n).dtype == np.int32
    jp = str(tmp_path / "jax.orbax")
    jax_save(jp, ref, JaxConfig(**CFG), source="test")
    assert _meta(p) == _meta(jp)


def test_jax_writes_port_reads_single_device(tmp_path):
    p = str(tmp_path / "tab.orbax")
    ref = _jax_table(1)
    jax_save(p, ref, JaxConfig(**CFG))
    got = checkpoint_orbax.load_table_orbax(p, EngineConfig(**CFG), device="cpu")
    keys, counts, n = table_to_numpy(got)
    assert n == int(ref.n)
    np.testing.assert_array_equal(keys, np.asarray(ref.keys))
    np.testing.assert_array_equal(counts, np.asarray(ref.counts))


def test_port_roundtrip_single_device(tmp_path):
    p = str(tmp_path / "tab.orbax")
    tab = _port_table(2)
    checkpoint_orbax.save_table_orbax(p, tab, EngineConfig(**CFG))
    checkpoint_orbax.save_table_orbax(p, tab, EngineConfig(**CFG))  # replaces, as force=True
    got = checkpoint_orbax.load_table_orbax(p, EngineConfig(**CFG), device="cpu")
    for a, b in zip(table_to_numpy(got), table_to_numpy(tab)):
        np.testing.assert_array_equal(a, b)


def test_semantics_hash_guard(tmp_path):
    p = str(tmp_path / "tab2.orbax")
    checkpoint_orbax.save_table_orbax(p, _port_table(1), EngineConfig(**CFG))
    with pytest.raises(CheckpointError, match="semantics mismatch"):
        checkpoint_orbax.load_table_orbax(p, dataclasses.replace(EngineConfig(**CFG), k=31),
                                          device="cpu")
    with pytest.raises(JaxCheckpointError, match="semantics mismatch"):
        jax_load(p, dataclasses.replace(JaxConfig(**CFG), k=31))


def test_port_engine_writes_jax_engine_reads(tmp_path):
    je, jt, pe, pt = _engines(6)
    p = str(tmp_path / "eng.orbax")
    pe.save_table(p, pt, source="s", backend="orbax")
    got = je.load_table(p, backend="orbax")
    for name in ("keys", "counts", "n"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(jt, name)))
    like = jax_load(p, je.cfg, like=je.empty_table())
    assert like.keys.sharding == je.empty_table().keys.sharding
    np.testing.assert_array_equal(np.asarray(like.keys), np.asarray(jt.keys))
    jp = str(tmp_path / "jax_eng.orbax")
    je.save_table(jp, jt, source="s", backend="orbax")
    assert _meta(p) == _meta(jp)


def test_jax_engine_writes_port_engine_reads(tmp_path):
    je, jt, pe, pt = _engines(7)
    p = str(tmp_path / "eng.orbax")
    je.save_table(p, jt, backend="orbax")
    got = pe.load_table(p, backend="orbax")
    for a, b in zip(pe.table_arrays(got), pe.table_arrays(pt)):
        np.testing.assert_array_equal(a, b)
    assert pe.total_unique(got) == pe.total_unique(pt)


def test_engine_orbax_geometry_and_flat_guard(tmp_path):
    _je, _jt, pe, pt = _engines(8)
    p = str(tmp_path / "eng.orbax")
    pe.save_table(p, pt, backend="orbax")
    with pytest.raises(CheckpointError, match="engine-layout"):
        checkpoint_orbax.load_table_orbax(p, pe.cfg, device="cpu")
    other = ShardedKmerEngine(pe.cfg, make_mesh((4, 2), device="cpu"))
    with pytest.raises(CheckpointError, match="geometry mismatch"):
        other.load_table(p, backend="orbax")


def test_missing_tensorstore_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    p = str(tmp_path / "tab.orbax")
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoint_orbax.save_table_orbax(p, _port_table(0), EngineConfig(**CFG))
    assert os.listdir(tmp_path) == []


def test_load_like_takes_the_tables_device(tmp_path):
    """``like=`` restores onto the device of the table given (JAX: onto its sharding), with
    no card needed when that table is on the CPU; the values are JAX's."""
    p = str(tmp_path / "tab.orbax")
    ref = _jax_table(3)
    jax_save(p, ref, JaxConfig(**CFG))
    want = jax_load(p, JaxConfig(**CFG), like=ref)
    got = checkpoint_orbax.load_table_orbax(p, EngineConfig(**CFG), like=_port_table(4))
    assert got.keys.device.type == "cpu"
    keys, counts, n = table_to_numpy(got)
    assert n == int(want.n)
    np.testing.assert_array_equal(keys, np.asarray(want.keys))
    np.testing.assert_array_equal(counts, np.asarray(want.counts))
