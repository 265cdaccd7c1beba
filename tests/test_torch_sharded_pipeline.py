"""The port's sharded pipelines (denovo_kmer_tpu_torch/parallel/pipeline.py) against the JAX
package's on the CPU (the forced 8 host devices; the port on R·T copies of the CPU), on the
trio of tests/test_sharded.py: run_trio_sharded on meshes (2,4), (4,2), (1,8), (8,1) at
k = 21 and on (2,4) at k = 32 (the compacting fallback), a (32,1) mesh (JAX needs 32 host
devices for it, so it is held to both packages' single-device run_trio), the route-overflow
retry of tests/test_route_retry.py, run_trio_multipass_sharded, run_trio_spill_sharded,
`count` checkpoints as parents, a region and length buckets; every report byte-equal to the
JAX package's and to the port's single-device run_trio. Tolerance 0."""

import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.parallel import pipeline as jpipe
from denovo_kmer_tpu.parallel.sharded_table import RouteOverflowError as JaxRouteOverflow
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.parallel import pipeline as pipe
from denovo_kmer_tpu_torch.parallel.mesh import make_mesh
from denovo_kmer_tpu_torch.parallel.sharded_table import RouteOverflowError
from denovo_kmer_tpu_torch.pipeline import build_sample_table, run_trio
from denovo_kmer_tpu_torch.utils.checkpoint import save_table
from denovo_kmer_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13)
SPEC = TrioSpec(genome_len=1500, read_len=50, coverage=6.0, seed=9,
                n_inherited_snvs=6, n_denovo_snvs=2, n_rate=0.002)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """tests/test_sharded.py's trio."""
    p = write_trio_bams(make_trio(SPEC), str(tmp_path_factory.mktemp("shard_trio")))
    return p["mom"], p["dad"], p["child"]


def _same(got, want):
    assert got.report == want.report
    assert got.candidates == want.candidates
    assert got.tables_n == want.tables_n


@pytest.fixture(scope="module")
def single(trio):
    """The port's single-device run_trio at each k, for every mesh."""
    return {k: run_trio(*trio, EngineConfig(**dict(CFG, k=k)), device="cpu")
            for k in (21, 32)}


@pytest.mark.parametrize("shape,k", [((2, 4), 21), ((4, 2), 21), ((1, 8), 21),
                                     ((8, 1), 21), ((2, 4), 32)])
def test_run_trio_sharded_matches_jax(trio, single, shape, k):
    cfg = dict(CFG, k=k, mesh_shape=shape)
    want = jpipe.run_trio_sharded(*trio, JaxConfig(**cfg))
    got = pipe.run_trio_sharded(*trio, EngineConfig(**cfg), device="cpu")
    _same(got, want)
    _same(got, single[k])
    assert got.candidates


def test_tall_32_row_mesh_matches_single_device(trio, single):
    """R = 32 (the JAX package's segmented-scan group sums; here the same exact sums): the
    report of JAX's and the port's single-device run_trio."""
    cfg = EngineConfig(**dict(CFG, batch_reads=64, mesh_shape=(32, 1)))
    got = pipe.run_trio_sharded(*trio, cfg, device="cpu")
    _same(got, single[21])
    _same(got, jax_run_trio(*trio, JaxConfig(**CFG)))


def test_route_overflow_retries_to_the_exact_result(trio):
    """tests/test_route_retry.py: a starved capacity factor (0.05) on a (1,8) mesh retries
    with doubled factors to the exact report; with one attempt it raises."""
    cfg = dict(CFG, accum_batches=2, mesh_shape=(1, 8), route_capacity_factor=0.05)
    m = Metrics()
    got = pipe.run_trio_sharded(*trio, EngineConfig(**cfg), m, max_route_retries=8,
                                device="cpu")
    want = jpipe.run_trio_sharded(*trio, JaxConfig(**cfg), max_route_retries=8)
    _same(got, want)
    assert got.metrics is m and m.counters["candidates"] == len(got.candidates)
    with pytest.raises(RouteOverflowError) as ep:
        pipe.run_trio_sharded(*trio, EngineConfig(**cfg), max_route_retries=1, device="cpu")
    with pytest.raises(JaxRouteOverflow) as ej:
        jpipe.run_trio_sharded(*trio, JaxConfig(**cfg), max_route_retries=1)
    assert str(ep.value) == str(ej.value)
    with pytest.raises(ValueError, match="max_route_retries must be >= 1"):
        pipe.run_trio_sharded(*trio, EngineConfig(**cfg), max_route_retries=0, device="cpu")


def test_multipass_sharded_matches_jax(trio, single):
    cfg = dict(CFG, mesh_shape=(2, 4))
    want = jpipe.run_trio_multipass_sharded(*trio, JaxConfig(**cfg), 2)
    got = pipe.run_trio_multipass_sharded(*trio, EngineConfig(**cfg), 2, device="cpu")
    _same(got, want)
    assert got.report == single[21].report


@pytest.mark.parametrize("passes,rows", [(3, 4096), (2, 1)])
def test_spill_sharded_matches_jax(trio, single, passes, rows):
    """A per-shard device store of ``rows`` rows a pass (rounded up to the staging window);
    1 row a pass still holds the trio, so the store's clamp slack is exercised."""
    cfg = dict(CFG, mesh_shape=(2, 4))
    want = jpipe.run_trio_spill_sharded(*trio, JaxConfig(**cfg), passes, rows)
    got = pipe.run_trio_spill_sharded(*trio, EngineConfig(**cfg), passes, rows, device="cpu")
    _same(got, want)
    assert got.report == single[21].report


def test_spill_store_overflow_raises_as_jax_does(tmp_path):
    """One window of rows a pass and a shard, five windows of 60 bp reads: the store
    overflows; both packages say so in the same words."""
    p = write_trio_bams(make_trio(TrioSpec(genome_len=1500, read_len=60, coverage=12.0,
                                           seed=3)), str(tmp_path))
    trio = (p["mom"], p["dad"], p["child"])
    cfg = dict(CFG, mesh_shape=(1, 2), accum_batches=1)
    msgs = []
    for run, c in ((jpipe.run_trio_spill_sharded, JaxConfig(**cfg)),
                   (lambda *a: pipe.run_trio_spill_sharded(*a, device="cpu"),
                    EngineConfig(**cfg))):
        with pytest.raises(RuntimeError, match="device store overflow") as e:
            run(*trio, c, 2, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_count_checkpoints_as_parents(trio, single, tmp_path):
    """`count` .npz parents are hash-partitioned onto the mesh (place_flat_table), also
    sliced per pass by the multipass."""
    mom, dad, child = trio
    paths = {}
    for name, path in (("mom", mom), ("dad", dad)):
        paths[name] = str(tmp_path / f"{name}.npz")
        save_table(paths[name], build_sample_table(path, EngineConfig(**CFG), device="cpu"),
                   EngineConfig(**CFG), source=path)
    cfg = dict(CFG, mesh_shape=(2, 4))
    want = jpipe.run_trio_sharded(paths["mom"], paths["dad"], child, JaxConfig(**cfg))
    got = pipe.run_trio_sharded(paths["mom"], paths["dad"], child, EngineConfig(**cfg),
                                device="cpu")
    _same(got, want)
    assert got.report == single[21].report
    got2 = pipe.run_trio_multipass_sharded(paths["mom"], paths["dad"], child,
                                           EngineConfig(**cfg), 2, device="cpu")
    assert got2.report == single[21].report


def test_region_and_buckets_match_jax(trio, tmp_path):
    """A full-scan --region (no index beside the synthetic BAMs) and length buckets over
    the mesh."""
    from denovo_kmer_tpu.io.bam import BamReader

    with open(trio[0], "rb") as f:
        ref = BamReader(f).references[0][0]
    for extra, region in ((dict(), f"{ref}:200-900"),
                          (dict(read_len_buckets=(32, 48, 64)), None)):
        cfg = dict(CFG, mesh_shape=(2, 4), **extra)
        want = jpipe.run_trio_sharded(*trio, JaxConfig(**cfg), region=region)
        got = pipe.run_trio_sharded(*trio, EngineConfig(**cfg), region=region, device="cpu")
        _same(got, want)


def test_explicit_mesh_and_device_resolution(trio, single):
    """A caller's mesh is used as given (a repeated device list); without one the mesh
    resolves to the card, which this host does not have."""
    cfg = EngineConfig(**dict(CFG, mesh_shape=(2, 2)))
    m = make_mesh((2, 2), [torch.device("cpu")] * 4)
    _same(pipe.run_trio_sharded(*trio, cfg, mesh=m), single[21])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            pipe.run_trio_sharded(*trio, cfg)


def test_compacting_score_build_matches_the_fused_call(trio, single):
    """build_score_table_sharded (the compacting finalize) then call_score: the candidates
    of the fused call and of the single-device run_trio."""
    cfg = EngineConfig(**dict(CFG, mesh_shape=(2, 4)))
    engine = pipe.ShardedKmerEngine(cfg, make_mesh((2, 4), device="cpu"))
    mom, dad = (pipe.load_or_build_parent_sharded(p, cfg, engine) for p in trio[:2])
    stab = pipe.build_score_table_sharded(trio[2], cfg, engine, mom, dad)
    assert engine.call_score(stab) == single[21].candidates
