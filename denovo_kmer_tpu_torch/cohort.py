"""Multi-k sweeps and cohort mode (BASELINE.json configs 4-5).

Port of the single-device half of ``denovo_kmer_tpu/cohort.py``.

- Multi-k: the packed-read layout does not depend on k (2-bit words + validity), so one host
  decode, and one placement of each batch on the device, feeds the extraction kernel once a
  k: every k has its own staging buffer, table and flush (one ``pipeline.FoldLane`` a k).
- Cohort: N trios through one ingest step, plus an optional parental superset table (the
  union of every parent's k-mers). Per-trio calls use that trio's own parents, so each
  trio's result equals its standalone ``run_trio``.

The sharded twins (``run_trio_multi_k_sharded``, ``run_cohort_sharded``) are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.table import KmerTable, empty_table, merge_tables
from denovo_kmer_tpu_torch.pipeline import (
    _NOT_YET,
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
    if region:
        raise NotImplementedError(f"--region: {_NOT_YET}")
    dev = resolve_device(device)
    m = metrics or Metrics()
    cfgs = {k: dataclasses.replace(base_cfg, k=k) for k in ks}

    tables: Dict[str, Dict[int, KmerTable]] = {}
    for name, path in (("mom", mom_path), ("dad", dad_path)):
        lanes = {k: SampleTableBuilder(cfgs[k], dev).lane() for k in ks}
        with m.timer(f"build_{name}"):
            _fold_placed(packed_batches(path, base_cfg), base_cfg, dev, list(lanes.values()),
                         m)
        tables[name] = {k: lane.state for k, lane in lanes.items()}
        for k in ks:
            _check_table(tables[name][k], cfgs[k], f"unique k-mers at k={k}")

    scorers = {k: ScoringTableBuilder(cfgs[k], dev) for k in ks}
    lanes = {k: scorers[k].child_lane(tables["mom"][k], tables["dad"][k]) for k in ks}
    with m.timer("build_child"):
        _fold_placed(packed_batches(child_path, base_cfg), base_cfg, dev, list(lanes.values()),
                     m)

    out: Dict[int, TrioResult] = {}
    for k in ks:
        cands, child_uniques = scorers[k].finish(lanes[k], m)
        tables_n = {"mom": int(tables["mom"][k].n), "dad": int(tables["dad"][k].n),
                    "child": child_uniques}
        out[k] = _trio_result(_candidate_parts(cands), k, m, tables_n)
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
    if region:
        raise NotImplementedError(f"--region: {_NOT_YET}")
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
        tables = _parent_tables(trio.mom, trio.dad, cfg, m, None, dev, step)
        if superset is not None:
            for parent in ("mom", "dad"):
                superset = merge_tables(superset, tables[parent], cfg.table_capacity)
                n_sup = int(superset.n)
                if n_sup > cfg.table_capacity:
                    raise TableOverflowError(
                        f"parental superset overflow at trio {trio.name} ({parent}): "
                        f"{n_sup} > {cfg.table_capacity}; rerun with a larger "
                        "--table-capacity")
        cands, child_uniques = score_child(cfg, dev, tables["mom"], tables["dad"],
                                           trio.child, m, append_packed=step)
        tables_n = {"mom": int(tables["mom"].n), "dad": int(tables["dad"].n),
                    "child": child_uniques}
        results[trio.name] = _trio_result(_candidate_parts(cands), cfg.k, m, tables_n)
        m.count("trios", 1)
    if superset is not None:
        m.count("superset_unique_kmers", int(superset.n))
    return results, superset
