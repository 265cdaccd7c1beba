"""Sharded trio pipelines: the mesh counterparts of ``pipeline.run_trio`` and its multipass.

Port of ``denovo_kmer_tpu/parallel/pipeline.py``. The host feed and the report are the
single-device ones; the device path streams global read batches over the whole mesh, builds
hash-sharded tables for all three samples, and runs the shard-local candidate call. Reports
equal the single-device path's (sharding partitions, never approximates).

Entry points run on the card unless the caller asks for the CPU (``device="cpu"``), or pass
a ``mesh`` (``parallel/mesh.make_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.prefetch import close_unless_leaked, prefetch_placed
from denovo_kmer_tpu_torch.oracle.scalar import format_report
from denovo_kmer_tpu_torch.parallel.mesh import make_mesh
from denovo_kmer_tpu_torch.parallel.sharded_table import (
    RouteOverflowError,
    ShardedBuildState,
    ShardedKmerEngine,
)
from denovo_kmer_tpu_torch.pipeline import (
    TrioResult,
    _bucketed_stream,
    _filter_table_by_pass,
    _report_feed_stats,
    packed_batches,
)
from denovo_kmer_tpu_torch.utils.checkpoint import maybe_load_flat_table
from denovo_kmer_tpu_torch.utils.metrics import Metrics


def _packed_batches(source, cfg: EngineConfig, region=None):
    """Packed batches for the mesh: length-bucketed when cfg.read_len_buckets is set (the
    sharded ingest takes the extraction width from the batch shape), else the fastest feeder
    of ``pipeline.packed_batches``."""
    if cfg.read_len_buckets:
        return (packed for _w, packed in _bucketed_stream(source, cfg, region))
    return packed_batches(source, cfg, region)


def _stream(engine: ShardedKmerEngine, state, source, cfg: EngineConfig, m: Metrics,
            ingest, pass_id: int = 0, region=None):
    """Decode, place (on the mesh's first device, prefetched) and ingest every batch of
    ``source`` into ``state``; the feed's starvation goes to ``m`` (``feed_wait``)."""
    feed_stats: dict = {}
    for packed in prefetch_placed(_packed_batches(source, cfg, region), engine.feed_device,
                                  ship_lengths=True, stats=feed_stats):
        m.count("reads_ingested", packed.n_reads)
        with m.timer("extract_probe"):
            state = ingest(state, packed, pass_id)
        m.count("kmers_extracted", packed.n_reads * cfg.windows_per_read)
        m.count("batches", 1)
    _report_feed_stats(m, feed_stats)
    return state


def build_sample_table_sharded(records, cfg: EngineConfig, engine: ShardedKmerEngine,
                               metrics: Optional[Metrics] = None, pass_id: int = 0,
                               region=None) -> list:
    """Fold a reads file (or a record iterable) into an engine-layout table."""
    m = metrics or Metrics()
    state = _stream(engine, engine.new_build(), records, cfg, m, engine.ingest, pass_id,
                    region)
    with m.timer("finalize"):
        table = engine.finalize(state)
    m.count("unique_kmers", engine.total_unique(table))
    return table


def load_or_build_parent_sharded(path, cfg: EngineConfig, engine: ShardedKmerEngine,
                                 metrics: Optional[Metrics] = None, region=None,
                                 pass_id: int = 0) -> list:
    """A parent's table from a `count` .npz checkpoint (hash-partitioned onto the mesh by
    ``place_flat_table``; a multipass engine takes this pass's keys of it) or by streaming
    the reads — the dispatch the trio and cohort pipelines share."""
    m = metrics or Metrics()
    loaded = maybe_load_flat_table(path, cfg, device="cpu")
    if loaded is not None:
        m.event("table_loaded", path=path)
        if engine.n_passes > 1:
            loaded = _filter_table_by_pass(loaded, engine.n_passes, pass_id)
        return engine.place_flat_table(loaded)
    return build_sample_table_sharded(path, cfg, engine, m, pass_id, region)


def ingest_score_state(child_records, cfg: EngineConfig, engine: ShardedKmerEngine, mom,
                       dad, metrics: Optional[Metrics] = None, pass_id: int = 0,
                       region=None) -> ShardedBuildState:
    """Stream the child through the parent-seeded scored ingest; returns the build state
    (callers pick the finalize: the compacting ``finalize_score`` or the fused
    ``finalize_call_score``)."""
    m = metrics or Metrics()
    return _stream(engine, engine.new_score_build(mom, dad), child_records, cfg, m,
                   engine.ingest_score, pass_id, region)


def build_score_table_sharded(child_records, cfg: EngineConfig, engine: ShardedKmerEngine,
                              mom, dad, metrics: Optional[Metrics] = None,
                              region=None) -> list:
    """The child's scoring table over the mesh (the compacting finalize)."""
    m = metrics or Metrics()
    state = ingest_score_state(child_records, cfg, engine, mom, dad, m, region=region)
    with m.timer("finalize"):
        return engine.finalize_score(state)


def with_route_retry(run, cfg: EngineConfig, metrics: Optional[Metrics],
                     max_route_retries: int):
    """``run(cfg, attempt_metrics)`` until its route fits: on RouteOverflowError the run
    restarts with a doubled route_capacity_factor, up to ``max_route_retries`` attempts
    (overflow raises, never drops). Each attempt counts on scratch Metrics that share the
    caller's event stream; only the successful attempt's counters and timers are merged."""
    if max_route_retries < 1:
        raise ValueError(f"max_route_retries must be >= 1, got {max_route_retries}")
    last_err = None
    for attempt in range(max_route_retries):
        attempt_metrics = Metrics(json_stream=metrics._json if metrics is not None else None)
        try:
            res = run(cfg, attempt_metrics)
        except RouteOverflowError as e:
            last_err = e
            if attempt + 1 < max_route_retries:
                new_factor = cfg.route_capacity_factor * 2
                if metrics is not None:
                    metrics.event("route_overflow_retry", attempt=attempt, factor=new_factor)
                cfg = dataclasses.replace(cfg, route_capacity_factor=new_factor)
            continue
        if metrics is not None:
            metrics.merge_from(attempt_metrics)
            if isinstance(res, TrioResult):
                res.metrics = metrics
        return res
    raise last_err


def run_trio_sharded(mom_path: str, dad_path: str, child_path: str, cfg: EngineConfig,
                     metrics: Optional[Metrics] = None, mesh=None,
                     max_route_retries: int = 3, region=None, device=None) -> TrioResult:
    """The trio over a mesh (``mesh``, else ``make_mesh(cfg.mesh_shape, device=device)``)
    with the route-capacity retry (``with_route_retry``)."""
    def run(cfg, m):
        return _run_trio_sharded_once(mom_path, dad_path, child_path, cfg, m, mesh, region,
                                      device)

    return with_route_retry(run, cfg, metrics, max_route_retries)


def _run_trio_sharded_once(mom_path, dad_path, child_path, cfg, m, mesh, region, device):
    mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, device=device)
    engine = ShardedKmerEngine(cfg, mesh)
    tables = {}
    for name, path in (("mom", mom_path), ("dad", dad_path)):
        with m.timer(f"build_{name}"):
            tables[name] = load_or_build_parent_sharded(path, cfg, engine, m, region=region)
        m.event("table_built", sample=name, unique=engine.total_unique(tables[name]))
    # the child: parent-seeded scored build, then the fused finalize + call
    with m.timer("build_child"):
        state = ingest_score_state(child_path, cfg, engine, tables["mom"], tables["dad"], m,
                                   region=region)
    with m.timer("trio_call"):
        cand_tuples, child_uniques = engine.finalize_call_score(state)
    m.event("table_built", sample="child", unique=child_uniques)
    m.count("candidates", len(cand_tuples))
    return TrioResult(
        candidates=cand_tuples, report=format_report(cand_tuples, cfg.k), metrics=m,
        tables_n={"mom": engine.total_unique(tables["mom"]),
                  "dad": engine.total_unique(tables["dad"]), "child": child_uniques})


def run_trio_multipass_sharded(mom_path: str, dad_path: str, child_path: str,
                               cfg: EngineConfig, n_passes: int,
                               metrics: Optional[Metrics] = None, mesh=None,
                               max_route_retries: int = 3, region=None,
                               device=None) -> TrioResult:
    """``--passes`` × ``--mesh``: the re-decode hash-pass partition of
    ``pipeline.run_trio_multipass`` over the sharded engine. Pass p keeps the k-mers whose
    ``router.pass_of`` bucket is p; the pass partition splits the key space, so the union of
    the per-pass candidates is exactly the single-pass result. Route overflow retries as in
    ``run_trio_sharded``."""
    if n_passes < 2:
        return run_trio_sharded(mom_path, dad_path, child_path, cfg, metrics, mesh,
                                max_route_retries, region, device)

    def run(cfg, m):
        return _run_trio_multipass_sharded_once(mom_path, dad_path, child_path, cfg,
                                                n_passes, m, mesh, region, device)

    return with_route_retry(run, cfg, metrics, max_route_retries)


def _run_trio_multipass_sharded_once(mom_path, dad_path, child_path, cfg, n_passes, m,
                                     mesh, region, device):
    mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, device=device)
    engine = ShardedKmerEngine(cfg, mesh, n_passes=n_passes)
    all_cands = []
    tables_n = {"mom": 0, "dad": 0, "child": 0}
    for p in range(n_passes):
        ptables = {}
        for name, path in (("mom", mom_path), ("dad", dad_path)):
            with m.timer(f"build_{name}"):
                ptables[name] = load_or_build_parent_sharded(path, cfg, engine, m,
                                                             region=region, pass_id=p)
            tables_n[name] += engine.total_unique(ptables[name])
        with m.timer("build_child"):
            state = ingest_score_state(child_path, cfg, engine, ptables["mom"],
                                       ptables["dad"], m, pass_id=p, region=region)
        with m.timer("trio_call"):
            cand_tuples, child_uniques = engine.finalize_call_score(state)
        tables_n["child"] += child_uniques
        all_cands.extend(cand_tuples)
        m.event("pass_done", pass_id=p, candidates=len(cand_tuples))
    all_cands.sort()  # the pass partition splits the key space
    m.count("candidates", len(all_cands))
    return TrioResult(candidates=all_cands, report=format_report(all_cands, cfg.k), metrics=m,
                      tables_n=tables_n)


def run_trio_spill_sharded(mom_path: str, dad_path: str, child_path: str,
                           cfg: EngineConfig, n_passes: int, device_store_rows: int,
                           metrics: Optional[Metrics] = None, mesh=None, region=None,
                           capacity_factor: float = 1.4, device=None) -> TrioResult:
    """The sharded SINGLE-DECODE multipass (the mesh twin of ``pipeline.run_trio_spill``):
    each sample is decoded and extracted once over the whole mesh; every staged window is
    partitioned by ``router.pass_of`` into per-pass row blocks of a per-shard device store;
    each counting pass folds only its own rows through the engine's route + aggregate, so
    every pass equals ``run_trio_multipass_sharded``'s.

    ``device_store_rows``: store rows a pass PER SHARD (rounded up to the staging window).
    A host-file spill on a mesh is not implemented, as in the JAX package."""
    from denovo_kmer_tpu_torch.ops.spill import SpillOverflowError

    if n_passes < 2:
        return run_trio_sharded(mom_path, dad_path, child_path, cfg, metrics, mesh,
                                region=region, device=device)
    m = metrics or Metrics()
    mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, device=device)
    engine = ShardedKmerEngine(cfg, mesh)
    sp = engine.spill_programs(n_passes, device_store_rows, capacity_factor)

    def spill_sample(name, path):
        acc, ovf = engine.new_acc_state()
        rows, fill = sp.new_store()
        pending = 0
        stream = _packed_batches(path, cfg, region)
        feed_stats: dict = {}
        feed = prefetch_placed(stream, engine.feed_device, ship_lengths=True,
                               stats=feed_stats)
        with m.timer(f"spill_{name}"):
            try:
                for packed in feed:
                    m.count("reads_ingested", packed.n_reads)
                    blocks = engine.put_batch(packed)
                    acc = engine._grid(lambda r, t, d: engine._extract(acc[r][t],
                                                                       blocks[r][t], 0))
                    m.count("kmers_extracted", packed.n_reads * cfg.windows_per_read)
                    pending += 1
                    if pending == cfg.accum_batches:
                        disp, counts, acc, ovf = sp.partition(acc, ovf)
                        rows, fill = sp.append(rows, fill, disp, counts)
                        pending = 0
            finally:
                feed.close()  # stop the prefetch threads before their input closes
                close_unless_leaked(stream, feed_stats)
            if pending:
                disp, counts, acc, ovf = sp.partition(acc, ovf)
                rows, fill = sp.append(rows, fill, disp, counts)
        _report_feed_stats(m, feed_stats)
        ovf_total = sum(int(x) for row in ovf for x in row)
        if ovf_total:
            raise SpillOverflowError(
                f"{ovf_total} k-mers overflowed the per-pass window capacity "
                f"{sp.window_cap} ({name}); raise capacity_factor "
                f"(={capacity_factor})"
            )
        fills = np.stack([np.stack([f.cpu().numpy() for f in row]) for row in fill])
        if fills.max(initial=0) > sp.rows_pp:
            raise SpillOverflowError(
                f"device store overflow ({name}): a device's pass holds "
                f"{int(fills.max())} rows > {sp.rows_pp}; raise device_store_rows"
            )
        m.event("spill_stored", sample=name, rows=int(fills.sum()))
        return rows, fill, fills

    stores = {name: spill_sample(name, path) for name, path in
              (("mom", mom_path), ("dad", dad_path), ("child", child_path))}

    def n_chunks(fills, p):
        return max(-(-int(fills[:, :, p].max(initial=0)) // sp.chunk_rows), 1)

    all_cands, tables_n = count_passes_from_spill(engine, sp, stores, n_passes, n_chunks, m)
    m.count("candidates", len(all_cands))
    return TrioResult(candidates=all_cands, report=format_report(all_cands, cfg.k), metrics=m,
                      tables_n=tables_n)


def count_passes_from_spill(engine: ShardedKmerEngine, sp, stores, n_passes: int, n_chunks,
                            metrics: Metrics, replicated_fetch: bool = False):
    """Per-pass counting from the per-shard stores, shared by the sharded and the
    multi-process spill: fold each sample's pass-``p`` rows through the engine's route +
    aggregate, finalize the parents, seed and fold the child's score table, and run the
    fused finalize + call. ``stores``: {mom/dad/child: (rows, fill, fills)};
    ``n_chunks(fills, p)``: the chunk count of one pass (the two callers index their fills
    differently). ``replicated_fetch``: multi-process mode (host values reduced over the
    ranks). Returns (sorted candidate tuples, tables_n)."""
    m = metrics
    acc0, _ = engine.new_acc_state()  # pending=0 never reads it
    all_cands = []
    tables_n = {"mom": 0, "dad": 0, "child": 0}
    for p in range(n_passes):
        with m.timer("count_passes"):
            ptabs = {}
            for name in ("mom", "dad"):
                rows, fill, fills = stores[name]
                tab, ovf = engine.empty_table(), engine.zeros_ovf()
                for ci in range(n_chunks(fills, p)):
                    tab, ovf = sp.fold(rows, fill, tab, ovf, p, ci * sp.chunk_rows)
                ptabs[name] = engine.finalize(
                    ShardedBuildState(acc=acc0, ovf=ovf, table=tab, pending=0),
                    replicated_fetch=replicated_fetch)
                tables_n[name] += engine.total_unique(ptabs[name])
            rows, fill, fills = stores["child"]
            stab, ovf = engine.seed_score(ptabs["mom"], ptabs["dad"]), engine.zeros_ovf()
            for ci in range(n_chunks(fills, p)):
                stab, ovf = sp.fold(rows, fill, stab, ovf, p, ci * sp.chunk_rows)
        with m.timer("trio_call"):
            cand_tuples, child_uniques = engine.finalize_call_score(
                ShardedBuildState(acc=acc0, ovf=ovf, table=stab, pending=0),
                replicated_fetch=replicated_fetch)
        tables_n["child"] += child_uniques
        all_cands.extend(cand_tuples)
        m.event("pass_done", pass_id=p, candidates=len(cand_tuples))
    all_cands.sort()  # the pass partition splits the key space
    return all_cands, tables_n
