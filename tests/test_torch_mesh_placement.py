"""The port's mesh placement (denovo_kmer_tpu_torch/parallel/mesh.py: ``place``, the locality
checks) against the JAX package's make_mesh on the same fake device lists, with
tests/test_mesh_placement.py's cases and more: each table-axis row inside one process whenever
the shape allows, process-major rows, flat order in one process, and the flat fallback with
JAX's warning text when T exceeds a process's devices. A process group of one rank keeps the
single-process mesh."""

import warnings

import numpy as np
import pytest
import torch

from denovo_kmer_tpu_torch.parallel.mesh import (
    Mesh,
    assert_table_axis_ici_local,
    make_mesh,
    place,
    table_axis_ici_local,
)


class FakeDev:
    def __init__(self, i, process_index):
        self.id = i
        self.process_index = process_index


class FakeMesh:
    def __init__(self, arr, axes):
        self.devices = np.array(arr)
        self.axis_names = axes


@pytest.fixture
def jax_mesh(monkeypatch):
    import denovo_kmer_tpu.parallel.mesh as M

    monkeypatch.setattr(M, "Mesh", FakeMesh)
    return M


CASES = [
    (4, 2, (4, 2)),
    (2, 4, (4, 2)),
    (1, 8, (2, 4)),
    (4, 2, (2, 4)),
    (2, 4, (2, 4)),
    (2, 4, (1, 8)),
    (3, 2, (3, 2)),
    (2, 4, (2, 2)),
    (2, 4, (8, 1)),
    (4, 2, (1, 8)),
]


def _port_mesh(idx, domains):
    grid = np.empty(idx.shape, dtype=object)
    grid[...] = torch.device("cpu")
    ranks = np.array([[domains[i] for i in row] for row in idx], dtype=np.int64)
    return Mesh(grid, ranks, 0, max(domains) + 1, "gloo")


@pytest.mark.parametrize("n_procs,per_proc,shape", CASES)
def test_placement_matches_jax(jax_mesh, n_procs, per_proc, shape):
    devs = [FakeDev(p * per_proc + i, p) for p in range(n_procs) for i in range(per_proc)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jm = jax_mesh.make_mesh(shape, devs)
    jax_msgs = [str(w.message) for w in caught]
    domains = [d.process_index for d in devs]
    idx, msg = place(shape, domains)
    assert idx.tolist() == [[d.id for d in row] for row in jm.devices]
    assert ([msg] if msg else []) == jax_msgs
    pm = _port_mesh(idx, domains)
    assert table_axis_ici_local(pm) == jax_mesh.table_axis_ici_local(jm)
    if table_axis_ici_local(pm):
        assert_table_axis_ici_local(pm)
    else:
        with pytest.raises(RuntimeError, match="spans locality domains"):
            assert_table_axis_ici_local(pm)


def test_single_process_meshes_are_local():
    mesh = make_mesh((2, 4), device="cpu")
    assert not mesh.spans_processes and mesh.local_cells() == [
        (r, t) for r in range(2) for t in range(4)]
    assert table_axis_ici_local(mesh)
    assert_table_axis_ici_local(mesh)


def test_group_of_one_keeps_the_single_process_mesh(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh((2, 2), device="cpu")
        assert not mesh.spans_processes and mesh.world == 1
        assert [str(d) for d in mesh.devices.reshape(-1)] == ["cpu"] * 4
        with pytest.raises(ValueError, match=r"mesh \(2, 2\) needs 4 devices, have 3"):
            make_mesh((2, 2), [torch.device("cpu")] * 3)
    finally:
        dist.destroy_process_group()
