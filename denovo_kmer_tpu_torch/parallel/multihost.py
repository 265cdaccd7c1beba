"""Multi-process trio workflow: the N-process counterpart of ``parallel.pipeline.run_trio_sharded``.

Port of ``denovo_kmer_tpu/parallel/multihost.py``. Each process feeds its record stripe (or
virtual-offset range) of every global batch (``distributed.host_packed_stream``), splits
it over its own mesh cells (``distributed.make_global_batch``), all processes execute the
same step sequence (``distributed.steps_aligned`` / ``steps_fixed``), and every host-side
decision value (overflow counters, table sizes, candidates) is reduced or gathered over the
ranks (``replicated_fetch=True``) so every process returns the same candidates.

Failure model: a dead process surfaces as a collective error (or the process group's
timeout) on the survivors; the supervisor re-launches the job, which resumes from the
per-sample table checkpoints at sample granularity.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.parallel.distributed import (
    host_packed_stream,
    make_global_batch,
    process_allgather,
    process_count,
    process_index,
    steps_aligned,
    sync_global_devices,
)
from denovo_kmer_tpu_torch.parallel.mesh import (
    assert_table_axis_ici_local,
    make_mesh,
    table_axis_ici_local,
)
from denovo_kmer_tpu_torch.parallel.sharded_table import ShardedKmerEngine


def _all_processes_see(path: str) -> bool:
    """Collective existence check: True iff EVERY process sees the file."""
    return bool(process_allgather(1 if os.path.exists(path) else 0).min())


def _make_stepper(path: str, cfg: EngineConfig, feed: str):
    """This host's step-aligned packed-batch stepper over ``path``, shared by the table
    build and the spill stream. ``feed``: "stripe" (every host decodes all records, keeps
    1/N) or "range" (virtual-offset ranges: each host decodes only its slice)."""
    host_id, n_hosts = process_index(), process_count()
    if feed == "range":
        # collective-free alignment: the split scan fixes every host's step count upfront
        from denovo_kmer_tpu_torch.parallel.distributed import (
            host_packed_stream_ranged,
            range_step_count,
            steps_fixed,
        )

        splits, n_steps = range_step_count(path, cfg, n_hosts)
        batches = host_packed_stream_ranged(path, cfg, host_id, n_hosts, splits)
        return steps_fixed(batches, cfg, n_steps)
    batches = host_packed_stream(read_bam_records(path), cfg, host_id, n_hosts)
    return steps_aligned(batches, cfg)


def build_sample_table_multihost(
    path: str,
    cfg: EngineConfig,
    engine: ShardedKmerEngine,
    fault_kill_after: Optional[int] = None,
    score_seed: Optional[Tuple] = None,
    feed: str = "stripe",
    return_state: bool = False,
    pass_id: int = 0,
):
    """Stream this host's share of ``path`` through the sharded engine (step-aligned).

    ``score_seed``: (mom_table, dad_table): the parent-seeded scored build instead of a
    plain table build. ``return_state``: return the raw build state instead of finalizing
    (callers that run the fused finalize_call_score themselves)."""
    if score_seed is not None:
        state = engine.new_score_build(*score_seed)
        ingest, finalize = engine.ingest_score_global, engine.finalize_score
    else:
        state = engine.new_build()
        ingest, finalize = engine.ingest_global, engine.finalize
    stepper = _make_stepper(path, cfg, feed)
    for i, local_packed in enumerate(stepper):
        if fault_kill_after is not None and i >= fault_kill_after:
            # fault injection (tests): die mid-build without cleanup
            os._exit(17)
        state = ingest(state, make_global_batch(engine, local_packed), pass_id)
    if return_state:
        return state
    return finalize(state, replicated_fetch=True)


def spill_sample_multihost(path, cfg: EngineConfig, engine: ShardedKmerEngine,
                           sp, feed: str = "stripe",
                           capacity_factor: float = 1.4):
    """Stream this host's share of ``path`` ONCE into the sharded spill store (the
    multi-process leg of the single-decode multipass; see
    ``parallel.pipeline.run_trio_spill_sharded``). Every host-side decision value is
    reduced over the ranks. Returns (rows, fill, fills) where ``fills`` is the (Pp,)
    per-pass max fill over every shard of every rank."""
    from denovo_kmer_tpu_torch.ops.spill import SpillOverflowError
    from denovo_kmer_tpu_torch.parallel.mesh import reduce_host

    stepper = _make_stepper(path, cfg, feed)
    acc, ovf = engine.new_acc_state()
    rows, fill = sp.new_store()
    pending = 0
    for local_packed in stepper:
        blocks = make_global_batch(engine, local_packed)
        acc = engine._grid(lambda r, t, d: engine._extract(acc[r][t], blocks[r][t], 0))
        pending += 1
        if pending == cfg.accum_batches:
            disp, counts, acc, ovf = sp.partition(acc, ovf)
            rows, fill = sp.append(rows, fill, disp, counts)
            pending = 0
    if pending:
        disp, counts, acc, ovf = sp.partition(acc, ovf)
        rows, fill = sp.append(rows, fill, disp, counts)
    mesh = engine.mesh
    ovf_total = reduce_host(mesh, sum(int(x) for x in engine._local(ovf)), "sum")
    if ovf_total:
        raise SpillOverflowError(
            f"{ovf_total} k-mers overflowed the per-pass window capacity "
            f"{sp.window_cap} ({path}); raise capacity_factor "
            f"(={capacity_factor}, run_trio_multihost spill_capacity_factor)"
        )
    local = np.stack([f.cpu().numpy() for f in engine._local(fill)]).max(axis=0)
    fills = np.array([reduce_host(mesh, int(v), "max") for v in local], dtype=np.int64)
    if fills.max(initial=0) > sp.rows_pp:
        raise SpillOverflowError(
            f"device store overflow ({path}): a device's pass holds "
            f"{int(fills.max())} rows > {sp.rows_pp}; raise spill_rows"
        )
    return rows, fill, fills


def run_trio_multihost(
    mom_path: str,
    dad_path: str,
    child_path: str,
    cfg: EngineConfig,
    checkpoint_dir: Optional[str] = None,
    fault: Optional[Tuple[str, int, int]] = None,
    feed: str = "stripe",
    n_passes: int = 1,
    require_ici_local: bool = False,
    spill_rows: Optional[int] = None,
    spill_capacity_factor: float = 1.4,
    mesh=None,
) -> List[Tuple[int, int, int, int]]:
    """Full trio on an already-initialized process group (``distributed.
    initialize_distributed``).

    ``checkpoint_dir``: per-sample sharded-table checkpoints; samples whose checkpoint exists
    are loaded, others are built and saved: restart-after-failure resumes here.
    ``fault``: (sample, process_id, after_batches): kill that process mid-build (tests only).
    ``n_passes``: the hash-pass partition composed with the multi-process mesh; each pass
    re-reads the streams and the candidate union is exactly the single-pass result.
    Per-sample checkpoints are single-pass only.
    ``require_ici_local``: fail fast unless every table-axis group sits inside one process.
    ``spill_rows``: the single-decode multipass through a per-shard device store of that
    many rows a pass a shard (needs ``n_passes >= 2``).
    ``mesh``: a mesh made by ``make_mesh`` (default ``make_mesh(cfg.mesh_shape)``: the
    visible cards of every rank).
    Returns candidate tuples (kmer_value, child, mom, dad) ascending; identical on all
    processes.
    """
    if n_passes > 1 and checkpoint_dir:
        raise ValueError("checkpoint_dir does not compose with n_passes > 1")
    if spill_rows is not None:
        if n_passes < 2:
            raise ValueError("spill_rows requires n_passes >= 2 "
                             "(the spill IS the multipass partition)")
        if checkpoint_dir or fault:
            raise ValueError("spill_rows composes with neither checkpoint_dir "
                             "nor fault injection")
    mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape)
    if require_ici_local:
        assert_table_axis_ici_local(mesh)
    elif not table_axis_ici_local(mesh) and process_index() == 0:
        print(
            "denovo-kmer: table axis spans hosts — the per-window route "
            "all_to_all rides the inter-host link; prefer a taller reads axis",
            file=sys.stderr,
        )
    if spill_rows is not None:
        # single-decode multipass: spill once per sample, count every pass from the
        # stores; the counting protocol is SHARED with the single-process sharded path
        from denovo_kmer_tpu_torch.parallel.pipeline import count_passes_from_spill
        from denovo_kmer_tpu_torch.utils.metrics import Metrics

        engine = ShardedKmerEngine(cfg, mesh)
        sp = engine.spill_programs(n_passes, spill_rows, spill_capacity_factor)
        stores = {
            name: spill_sample_multihost(path, cfg, engine, sp, feed=feed,
                                         capacity_factor=spill_capacity_factor)
            for name, path in (("mom", mom_path), ("dad", dad_path),
                               ("child", child_path))
        }

        def _nch(fills, p):
            return max(-(-int(fills[p]) // sp.chunk_rows), 1)

        spill_out, _tables_n = count_passes_from_spill(
            engine, sp, stores, n_passes, _nch, Metrics(), replicated_fetch=True,
        )
        return spill_out

    engine = ShardedKmerEngine(cfg, mesh, n_passes=n_passes)
    host_id = process_index()

    all_out: List[Tuple[int, int, int, int]] = []
    for p in range(n_passes):
        tables: Dict[str, object] = {}
        for name, path in (("mom", mom_path), ("dad", dad_path)):
            ckpt = (
                os.path.join(checkpoint_dir, f"{name}.table.npz")
                if checkpoint_dir else None
            )
            if ckpt and _all_processes_see(ckpt):
                # the load-vs-build decision must be COLLECTIVE: a split decision would
                # deadlock the collectives, so load only when every process sees the file
                tables[name] = engine.load_table(ckpt)
                continue
            kill = None
            if fault and fault[0] == name and fault[1] == host_id:
                kill = fault[2]
            tables[name] = build_sample_table_multihost(
                path, cfg, engine, kill, feed=feed, pass_id=p
            )
            if ckpt:
                # collective: every process joins the gather; only process 0 writes
                engine.save_table(ckpt, tables[name], source=path, write=host_id == 0)
                sync_global_devices(f"ckpt_{name}")

        # child: parent-seeded scored build, then the fused finalize + call
        kill = None
        if fault and fault[0] == "child" and fault[1] == host_id:
            kill = fault[2]
        state = build_sample_table_multihost(
            child_path, cfg, engine, kill,
            score_seed=(tables["mom"], tables["dad"]), feed=feed,
            return_state=True, pass_id=p,
        )
        out, _n_child_unique = engine.finalize_call_score(state, replicated_fetch=True)
        all_out.extend(out)
    all_out.sort()  # the pass partition splits the key space: union == single-pass
    return all_out
