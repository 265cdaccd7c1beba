"""The port's multi-process feeding helpers (denovo_kmer_tpu_torch/parallel/distributed.py)
against the JAX package's, in a world-size-1 gloo process group on a file:// store
(destroyed after each test): record striping, the striped and the ranged packed streams,
steps_aligned (padding chunks), steps_fixed (padding and the overrun error) and
range_step_count, each equal batch for batch; initialize_distributed from JAX's env vars."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.io.bam import read_bam_records as jax_read_bam_records
from denovo_kmer_tpu.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu.parallel import distributed as J
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.parallel import distributed as P

CFG = dict(k=21, max_read_len=64, batch_reads=64)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_bam")
    write_trio_bams(make_trio(TrioSpec(genome_len=3000, read_len=50, coverage=6.0, seed=5)),
                    str(d))
    return os.path.join(str(d), "child.bam")


@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def _same(jb, pb):
    jb, pb = list(jb), list(pb)
    assert len(jb) == len(pb)
    for a, b in zip(jb, pb):
        assert a.n_reads == b.n_reads and bool(a.prefix_valid) == bool(b.prefix_valid)
        for name in ("words", "vwords", "length"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)))
    return len(pb)


@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (0, 2), (1, 2), (2, 4)])
def test_striping_and_packed_streams_match_jax(bam, group, host_id, n_hosts):
    seq = list(range(23))
    assert list(P.striped_records(seq, host_id, n_hosts)) == list(
        J.striped_records(seq, host_id, n_hosts))
    n = _same(J.host_packed_stream(jax_read_bam_records(bam), JaxConfig(**CFG), host_id,
                                   n_hosts),
              P.host_packed_stream(read_bam_records(bam), EngineConfig(**CFG), host_id,
                                   n_hosts))
    assert n > 1
    _same(J.host_packed_stream_ranged(bam, JaxConfig(**CFG), host_id, n_hosts),
          P.host_packed_stream_ranged(bam, EngineConfig(**CFG), host_id, n_hosts))
    assert P.range_step_count(bam, EngineConfig(**CFG), n_hosts) == J.range_step_count(
        bam, JaxConfig(**CFG), n_hosts)


def test_batch_reads_must_divide_by_hosts(bam):
    for mod, cfg in ((J, JaxConfig(**CFG)), (P, EngineConfig(**CFG))):
        with pytest.raises(ValueError, match=r"must divide by n_hosts \(3\)"):
            mod.host_packed_stream(iter(()), cfg, 0, 3)


@pytest.mark.parametrize("sync_every", [1, 3, 16])
def test_steps_aligned_matches_jax(bam, group, sync_every):
    jcfg, pcfg = JaxConfig(**CFG), EngineConfig(**CFG)
    n = _same(J.steps_aligned(J.host_packed_stream(jax_read_bam_records(bam), jcfg, 0, 1),
                              jcfg, sync_every),
              P.steps_aligned(P.host_packed_stream(read_bam_records(bam), pcfg, 0, 1),
                              pcfg, sync_every))
    assert n % sync_every == 0  # whole chunks, the last one all padding
    empty = P._empty_local_batch(pcfg)
    assert empty.n_reads == 0 and empty.words.shape[0] == pcfg.batch_reads


def test_steps_fixed_pads_and_refuses_overrun(bam, group):
    jcfg, pcfg = JaxConfig(**CFG), EngineConfig(**CFG)
    splits, n_steps = P.range_step_count(bam, pcfg, 1)
    for extra in (0, 2):
        _same(J.steps_fixed(J.host_packed_stream_ranged(bam, jcfg, 0, 1, splits), jcfg,
                            n_steps + extra),
              P.steps_fixed(P.host_packed_stream_ranged(bam, pcfg, 0, 1, splits), pcfg,
                            n_steps + extra))
    for mod, cfg, read in ((J, jcfg, jax_read_bam_records), (P, pcfg, read_bam_records)):
        with pytest.raises(RuntimeError, match="exceeds the fixed step count"):
            list(mod.steps_fixed(mod.host_packed_stream(read(bam), cfg, 0, 1), cfg,
                                 n_steps - 1))


def test_process_helpers_in_a_group_of_one(group):
    assert P.process_index() == 0 and P.process_count() == 1
    assert P.process_allgather(5).tolist() == [5]
    P.sync_global_devices("x")


def test_initialize_distributed_reads_jax_env_vars(monkeypatch):
    from _torch_multihost import free_port

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    P.initialize_distributed(backend="gloo", timeout=30)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    # the default backend is the card's: without a card that raises, as every entry
    # point's default device does, and no group is started on another backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        P.initialize_distributed(timeout=30)
    assert not dist.is_initialized()
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name)
    with pytest.raises(ValueError, match="coordinator address"):
        P.initialize_distributed(backend="gloo")


def test_local_config_is_a_share_of_the_batch():
    cfg = EngineConfig(**CFG)
    assert P._local_cfg(cfg, 4) == dataclasses.replace(cfg, batch_reads=16)
