"""Multi-k sweeps and cohort mode (BASELINE.json configs 4-5).

Port of the single-device half of ``denovo_kmer_tpu/cohort.py``.

- Multi-k: the packed-read layout does not depend on k (2-bit words + validity), so one host
  decode, and one placement of each batch on the device, feeds the extraction kernel once a
  k: every k has its own staging buffer, table and flush (one ``pipeline.FoldLane`` a k).
- Cohort: N trios through one ingest step, plus an optional parental superset table (the
  union of every parent's k-mers). Per-trio calls use that trio's own parents, so each
  trio's result equals its standalone ``run_trio``.

The sharded twins (``run_trio_multi_k_sharded``, ``run_cohort_sharded``) run the same over a
device mesh through ``parallel/sharded_table.ShardedKmerEngine``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.table import KmerTable, empty_table, merge_tables
from denovo_kmer_tpu_torch.pipeline import (
    ScoringTableBuilder,
    SampleTableBuilder,
    TableOverflowError,
    TrioResult,
    _candidate_parts,
    _check_table,
    _fold_placed,
    _parent_tables,
    _trio_result,
    make_ingest_step,
    packed_batches,
    resolve_device,
    score_child,
)
from denovo_kmer_tpu_torch.utils.metrics import Metrics


def run_trio_multi_k(
    mom_path: str,
    dad_path: str,
    child_path: str,
    base_cfg: EngineConfig,
    ks: Sequence[int],
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    device=None,
) -> Dict[int, TrioResult]:
    """One decode pass per sample, one table per (sample, k); trio call per k.

    All configs share every knob except k (SPEC_SEMANTICS: k changes the k-mer universe, so
    each k gets its own parity-complete result). ``ScoringTableBuilder.child_lane`` and
    ``finish`` choose per k: the fused call where the k allows it, else (``2k % 32 == 0``)
    the compacting build and ``call_from_score`` (the JAX package sends every k there when
    one k needs it; the results are the same).
    ``device=None`` runs on the card."""
    dev = resolve_device(device)
    m = metrics or Metrics()
    cfgs = {k: dataclasses.replace(base_cfg, k=k) for k in ks}

    tables: Dict[str, Dict[int, KmerTable]] = {}
    for name, path in (("mom", mom_path), ("dad", dad_path)):
        lanes = {k: SampleTableBuilder(cfgs[k], dev).lane() for k in cfgs}
        with m.timer(f"build_{name}"):
            _fold_placed(packed_batches(path, base_cfg, region), base_cfg, dev,
                         list(lanes.values()), m)
        tables[name] = {k: lane.state for k, lane in lanes.items()}
        del lanes  # its staging buffers, before the next sample's are allocated
        for k in cfgs:
            _check_table(tables[name][k], cfgs[k], f"unique k-mers at k={k}")
    tables_n = {k: {name: int(tables[name][k].n) for name in tables} for k in cfgs}

    # Each lane's seed takes its two parental tables out of ``tables``, so they are freed
    # once it is seeded: a lane of W words trades 2·(4W+4) B a capacity row of parental
    # tables for a (4W+8)-B scoring table. The seed is the run's largest step (it sorts
    # twice the capacity) and grows with W, so the lanes seed narrowest first: the widest
    # seeds when the fewest parental tables are left (``cli.window_peak`` models this order).
    # The seeds are part of the child's build, as in ``run_trio``.
    scorers = {k: ScoringTableBuilder(cfgs[k], dev) for k in cfgs}
    lanes = {}
    with m.timer("build_child"):
        for k in sorted(cfgs, key=lambda k: (cfgs[k].words, k)):
            lanes[k] = scorers[k].child_lane(tables["mom"].pop(k), tables["dad"].pop(k))
        _fold_placed(packed_batches(child_path, base_cfg, region), base_cfg, dev,
                     list(lanes.values()), m)

    out: Dict[int, TrioResult] = {}
    for k in cfgs:
        cands, child_uniques = scorers[k].finish(lanes.pop(k), m)
        out[k] = _trio_result(_candidate_parts(cands), k, m,
                              dict(tables_n[k], child=child_uniques))
    return out


@dataclasses.dataclass
class TrioPaths:
    name: str
    mom: str
    dad: str
    child: str


def run_cohort(
    trios: Sequence[TrioPaths],
    cfg: EngineConfig,
    metrics: Optional[Metrics] = None,
    build_parental_superset: bool = True,
    region: Optional[str] = None,
    device=None,
) -> Tuple[Dict[str, TrioResult], Optional[KmerTable]]:
    """Cohort mode (BASELINE.json config 5): N trios through one ingest step.

    Parents given as `count` checkpoints (``.npz``) load instead of building. With
    ``build_parental_superset`` every trio's parental tables are also merged into one
    superset table (a k-mer absent from it is de novo cohort-wide); the superset is checked
    after every merge, since a later merge recomputes ``n`` from the surviving rows and
    would mask an earlier overflow. ``device=None`` runs on the card."""
    dev = resolve_device(device)
    m = metrics or Metrics()
    # one ingest step serves every sample: the cohort streams unbucketed, as the JAX
    # package's does (bucketing gives the same tables)
    cfg = dataclasses.replace(cfg, read_len_buckets=None)
    step = make_ingest_step(cfg)
    superset = (empty_table(cfg.table_capacity, cfg.words, dev)
                if build_parental_superset else None)
    results: Dict[str, TrioResult] = {}
    for trio in trios:
        tables = _parent_tables(trio.mom, trio.dad, cfg, m, region, dev, step)
        if superset is not None:
            for parent in ("mom", "dad"):
                superset = merge_tables(superset, tables[parent], cfg.table_capacity)
                n_sup = int(superset.n)
                if n_sup > cfg.table_capacity:
                    raise TableOverflowError(
                        f"parental superset overflow at trio {trio.name} ({parent}): "
                        f"{n_sup} > {cfg.table_capacity}; rerun with a larger "
                        "--table-capacity")
        tables_n = {name: int(t.n) for name, t in tables.items()}
        cands, tables_n["child"] = score_child(cfg, dev, tables, trio.child, m, region,
                                               append_packed=step)
        results[trio.name] = _trio_result(_candidate_parts(cands), cfg.k, m, tables_n)
        m.count("trios", 1)
    if superset is not None:
        m.count("superset_unique_kmers", int(superset.n))
    return results, superset


def run_trio_multi_k_sharded(
    mom_path: str,
    dad_path: str,
    child_path: str,
    base_cfg: EngineConfig,
    ks: Sequence[int],
    metrics: Optional[Metrics] = None,
    mesh=None,
    region: Optional[str] = None,
    max_route_retries: int = 3,
    device=None,
) -> Dict[int, TrioResult]:
    """The multi-k sweep over a device mesh: one decode and one placement a batch feeds a
    ``ShardedKmerEngine`` a k, all on ONE mesh, each hash-sharding its own tables; every k
    finishes through the fused finalize + call (the compacting fallback at even k). Route
    overflow reruns the whole sweep with a doubled capacity factor, as ``run_trio_sharded``
    does. ``device=None`` runs on the card."""
    from denovo_kmer_tpu_torch.parallel.pipeline import with_route_retry

    def run(cfg, m):
        return _run_trio_multi_k_sharded_once(mom_path, dad_path, child_path, cfg, ks, m,
                                              mesh, region, device)

    return with_route_retry(run, base_cfg, metrics, max_route_retries)


def _run_trio_multi_k_sharded_once(mom_path, dad_path, child_path, base_cfg, ks, m, mesh,
                                   region, device) -> Dict[int, TrioResult]:
    from denovo_kmer_tpu_torch.io.prefetch import prefetch_placed
    from denovo_kmer_tpu_torch.parallel.mesh import make_mesh
    from denovo_kmer_tpu_torch.oracle.scalar import format_report
    from denovo_kmer_tpu_torch.parallel.sharded_table import ShardedKmerEngine
    from denovo_kmer_tpu_torch.pipeline import _report_feed_stats

    mesh = mesh if mesh is not None else make_mesh(base_cfg.mesh_shape, device=device)
    cfgs = {k: dataclasses.replace(base_cfg, k=k) for k in ks}
    engines = {k: ShardedKmerEngine(cfgs[k], mesh) for k in ks}
    e0 = engines[ks[0]]

    def stream_all(path, states, ingest_global):
        # ONE decode, placement and split a batch; every k's engine ingests the same blocks
        feed_stats: dict = {}
        for packed in prefetch_placed(packed_batches(path, base_cfg, region), e0.feed_device,
                                      ship_lengths=True, stats=feed_stats):
            m.count("reads_ingested", packed.n_reads)
            blocks = e0.put_batch(packed)
            for k in ks:
                with m.timer("extract_probe"):
                    states[k] = ingest_global[k](states[k], blocks)
                m.count("kmers_extracted", packed.n_reads * cfgs[k].windows_per_read)
        _report_feed_stats(m, feed_stats)

    tables: Dict[str, Dict[int, list]] = {}
    for name, path in (("mom", mom_path), ("dad", dad_path)):
        states = {k: engines[k].new_build() for k in ks}
        stream_all(path, states, {k: engines[k].ingest_global for k in ks})
        tables[name] = {k: engines[k].finalize(states[k]) for k in ks}

    states = {k: engines[k].new_score_build(tables["mom"][k], tables["dad"][k]) for k in ks}
    stream_all(child_path, states, {k: engines[k].ingest_score_global for k in ks})

    out: Dict[int, TrioResult] = {}
    for k in ks:
        cands, child_uniques = engines[k].finalize_call_score(states[k])
        out[k] = TrioResult(
            candidates=list(cands), report=format_report(cands, k), metrics=m,
            tables_n={"mom": engines[k].total_unique(tables["mom"][k]),
                      "dad": engines[k].total_unique(tables["dad"][k]),
                      "child": child_uniques})
    return out


def run_cohort_sharded(
    trios: Sequence[TrioPaths],
    cfg: EngineConfig,
    metrics: Optional[Metrics] = None,
    mesh=None,
    build_parental_superset: bool = True,
    region: Optional[str] = None,
    superset_out: Optional[str] = None,
    device=None,
):
    """Cohort mode on a device mesh: ONE ShardedKmerEngine streams all 3N samples; the
    parental superset folds shard-locally (one owner function everywhere) and, with
    ``superset_out``, is saved in engine layout (``ShardedKmerEngine.save_table``). Each
    trio's call uses its own parents, so it equals that trio run alone.

    Returns ({trio_name: [(kmer_value, child, mom, dad), ...]}, superset | None).
    ``device=None`` runs on the card."""
    from denovo_kmer_tpu_torch.parallel.mesh import make_mesh
    from denovo_kmer_tpu_torch.parallel.pipeline import (
        ingest_score_state,
        load_or_build_parent_sharded,
    )
    from denovo_kmer_tpu_torch.parallel.sharded_table import ShardedKmerEngine

    m = metrics or Metrics()
    mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, device=device)
    engine = ShardedKmerEngine(cfg, mesh)
    results = {}
    superset = engine.empty_table() if build_parental_superset else None
    for trio in trios:
        mom = load_or_build_parent_sharded(trio.mom, cfg, engine, m, region=region)
        dad = load_or_build_parent_sharded(trio.dad, cfg, engine, m, region=region)
        if superset is not None:
            # a merge drops overflow rows and a later merge would recompute n from the
            # survivors: check after every fold
            for parent_tab, pname in ((mom, "mom"), (dad, "dad")):
                superset = engine.merge_sharded_tables(superset, parent_tab)
                n_max = engine._max_n(superset)
                if n_max > engine.shard_capacity:
                    raise RuntimeError(
                        f"parental superset shard overflow at trio {trio.name} "
                        f"({pname}): {n_max} > {engine.shard_capacity}; "
                        f"raise --table-capacity"
                    )
        state = ingest_score_state(trio.child, cfg, engine, mom, dad, m, region=region)
        cands, _n_child_unique = engine.finalize_call_score(state)
        results[trio.name] = cands
        m.count("trios", 1)
    if superset is not None:
        m.count("superset_unique_kmers", engine.total_unique(superset))
        if superset_out is not None:
            engine.save_table(superset_out, superset, source="cohort-superset")
    return results, superset
