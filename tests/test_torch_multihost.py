"""The port's multi-process trio (denovo_kmer_tpu_torch/parallel/multihost.py over
torch.distributed, gloo on the CPU) in N real OS processes, on tests/test_multihost.py's trio
and config: every rank's report equals the JAX package's single-process run_trio report,
at 2 ranks on a 2x4 mesh, 4 ranks x 2 devices on 2x4 (the table axis spans ranks: warns) and
on the ICI-local (4,2), and on the (1,8) mesh whose route all_to_all crosses ranks (warns;
require_ici_local refuses it); the collectives on meshes that span ranks equal the
one-process collectives. A killed rank surfaces as a failure on the survivor, and the
relaunch resumes from the npz checkpoints, which equal the JAX engine's single-process
save_table arrays and meta. Feeds and multipass: tests/test_torch_multihost_feed.py."""

import json
import os

import jax
import numpy as np
import pytest

from _torch_multihost import CFG, jax_report, launch, reports, run_ok, wait_all, write_trio


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = write_trio(tmp_path_factory.mktemp("torch_mh_trio"))
    return d, jax_report(d)


@pytest.mark.parametrize("n_procs,devices,mesh,warns", [
    (2, 4, "2x4", False),
    (4, 2, "2x4", True),
    (4, 2, "4x2", False),
    (2, 4, "1x8", True),
], ids=["2proc_2x4", "4proc_2x4", "4proc_4x2_ici_local", "2proc_1x8_spanning"])
def test_multiprocess_trio_matches_jax_single_host(trio, tmp_path, n_procs, devices, mesh,
                                                   warns):
    d, golden = trio
    out = str(tmp_path / "mh.tsv")
    extra = ["--devices-per-proc", str(devices), "--mesh", mesh]
    if not warns:
        extra.append("--require-ici-local")
    results = run_ok(n_procs, d, out, extra)
    assert reports(out, n_procs) == [golden] * n_procs
    warned = ["cannot fit inside one locality domain" in se for _rc, _so, se in results]
    assert warned == [warns] * n_procs
    if warns:
        assert "table axis spans hosts" in results[0][2]


@pytest.mark.parametrize("n_procs,devices,mesh", [
    (2, 4, "2x4"), (2, 4, "1x8"), (4, 2, "2x4"), (4, 2, "4x2"), (2, 4, "8x1"),
])
def test_collectives_across_ranks_match_one_process(trio, tmp_path, n_procs, devices, mesh):
    """all_to_all, psum over each axis set and all_gather on a mesh whose cells span
    ranks give each rank's cells exactly the one-process collectives' values."""
    d, _golden = trio
    out = str(tmp_path / "coll")
    run_ok(n_procs, d, out, ["--devices-per-proc", str(devices), "--mesh", mesh,
                             "--collectives"])
    assert all(text.startswith("collectives ok") for text in reports(out, n_procs))


def test_spanning_mesh_refused_when_ici_local_required(trio, tmp_path):
    d, _golden = trio
    results = wait_all(launch(2, d, str(tmp_path / "x.tsv"),
                              ["--mesh", "1x8", "--require-ici-local"]))
    for rc, _so, se in results:
        assert rc != 0 and "table axis spans locality domains" in se
    assert not os.path.exists(tmp_path / "x.tsv")


def _jax_checkpoint(d, tmp_path, name):
    """The JAX engine's single-process save_table of one parent on a 2x4 mesh."""
    from denovo_kmer_tpu.config import EngineConfig
    from denovo_kmer_tpu.parallel.mesh import make_mesh
    from denovo_kmer_tpu.parallel.pipeline import build_sample_table_sharded
    from denovo_kmer_tpu.parallel.sharded_table import ShardedKmerEngine

    cfg = EngineConfig(**CFG, mesh_shape=(2, 4))
    engine = ShardedKmerEngine(cfg, make_mesh((2, 4), jax.devices()[:8]))
    src = os.path.join(d, f"{name}.bam")
    path = str(tmp_path / f"jax_{name}.npz")
    engine.save_table(path, build_sample_table_sharded(src, cfg, engine), source=src)
    return path


def test_killed_process_surfaces_and_restart_recovers(trio, tmp_path):
    d, golden = trio
    out = str(tmp_path / "mh_fault.tsv")
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    # rank 1 dies mid-way through the dad build: the survivor must fail, not hang or pass
    results = wait_all(launch(2, d, out, ["--ckpt-dir", ckpt, "--fault", "dad:1:1",
                                          "--timeout", "30"]))
    assert results[1][0] == 17
    assert results[0][0] != 0
    assert not os.path.exists(out)
    mom = os.path.join(ckpt, "mom.table.npz")
    assert os.path.exists(mom) and not os.path.exists(os.path.join(ckpt, "dad.table.npz"))

    # the supervisor's restart: the same command resumes from the checkpoint and completes
    run_ok(2, d, out, ["--ckpt-dir", ckpt])
    assert reports(out, 2) == [golden, golden]
    for name in ("mom", "dad"):
        ref = _jax_checkpoint(d, tmp_path, name)
        with np.load(os.path.join(ckpt, f"{name}.table.npz")) as a, np.load(ref) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in ("keys", "counts", "n"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            assert json.loads(bytes(a["meta"])) == json.loads(bytes(b["meta"]))
