"""Hash-sharded k-mer table engine over a (reads × table) device mesh.

Port of ``denovo_kmer_tpu/parallel/sharded_table.py``. One controller drives every shard
(``parallel/mesh.py``); each per-device body of the JAX ``shard_map`` programs is a function
run once a shard, and the collectives between them are ``mesh.all_to_all`` / ``psum`` /
``all_gather`` over per-shard lists ``x[r][t]``:

- A global read batch splits over ALL shards: shard (r, t) takes block ``r·T + t`` of
  ``batch_reads / (R·T)`` reads (JAX's ``P((reads, table))`` placement). Each shard extracts
  its reads straight into its own staging buffer (``ops/extract.extract_append``: on the card
  the kernel ``csrc/extract_kmers.cu``, one launch a shard a batch), with the multipass filter
  when the engine has ``n_passes > 1``.
- Once a window (``accum_batches`` batches), every shard buckets its staged k-mers by owner
  shard (``router.bucketize``), the buckets cross the table axis in one all_to_all, and each
  shard folds what it received into its *row partial* of table shard ``t``. With
  ``overlap_route`` (the default, JAX's ``DENOVO_OVERLAP_ROUTE=1``) a full window is routed
  by the next ingest just before that batch is extracted into the emptied buffer (the JAX
  fused flush+ingest); without it the window is routed right after its last batch. Both
  route the same windows, so the tables are identical.
- ``finalize`` gathers the R row partials of each column over the reads axis and merges
  them, leaving every row holding the complete shard ``t``. A window folds into a row
  partial as a single-device flush folds its staging window (``ops/stream.flush``), so each
  table stays sorted and unique and every fold into one is a merge.
- The child is scored against a parent-seeded table (seeded on row 0 only: the finalize sums
  row partials) and ``finalize_call_score`` runs the fused call on the gathered partials:
  one key sort a shard and exact group sums (``ops/fused.call_rows``). The JAX call computes
  those sums by R shifted adds for R ≤ 16 and ``segmented_suffix_sums`` above, in a 3-operand
  v5 variant with a carry-bit rerun through v4 and a candidate capacity K with retries; all
  of them equal v4's uint32 group sums, which ``call_rows`` computes for every R, so none of
  those branches exists here. Even k (``2k % 32 == 0``) takes the compacting fallback.

Several processes (``parallel/multihost.py``): each rank runs the per-shard bodies of its own
cells only (the others hold ``None``), feeds its own share of every batch
(``put_batch`` splits it over its local shards), and the collectives cross ranks through
``torch.distributed``. Every host-side decision value (overflow, sizes, candidates) is then
reduced or gathered over the ranks (``replicated_fetch=True``, as in JAX), so every rank
returns the same candidates; ``save_table`` is collective and only the ``write`` rank writes.

Exactness: the router never drops k-mers silently — dispatch overflow is counted, summed over
the mesh and checked host-side (``RouteOverflowError``; the pipelines retry with a larger
capacity factor). Table overflow is sticky from window to finalize.
"""

from __future__ import annotations

import dataclasses
import json
import types
from typing import List, Optional, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor
from denovo_kmer_tpu_torch.ops.extract import extract_append
from denovo_kmer_tpu_torch.ops.fused import call_rows, fused_supported
from denovo_kmer_tpu_torch.ops.score import (
    ScoreTable,
    call_from_score,
    empty_score_table,
    seed_score_table,
)
from denovo_kmer_tpu_torch.ops.score import flush_score as flush_score_table
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, empty_accumulator, staged_valid
from denovo_kmer_tpu_torch.ops.stream import flush as flush_table
from denovo_kmer_tpu_torch.ops.table import (
    PAD,
    KmerTable,
    _merge_sorted,
    _sticky_overflow_n,
    empty_table,
    merge_tables,
    table_from_numpy,
    u32,
)
from denovo_kmer_tpu_torch.ops.trio import call_candidates
from denovo_kmer_tpu_torch.oracle.scalar import words_to_kmer_value
from denovo_kmer_tpu_torch.parallel.mesh import (
    AXIS_READS,
    AXIS_TABLE,
    Mesh,
    all_gather,
    all_to_all,
    gather_cells,
    gather_objects,
    psum,
    reduce_host,
)
from denovo_kmer_tpu_torch.parallel.router import bucketize, owner_of, pass_of, route_capacity


def _sharded_overflow_msg(n_max: int, cap: int) -> str:
    return (
        f"score-table shard overflow: {n_max} uniques (child ∪ parents) > shard "
        f"capacity {cap}; raise --table-capacity"
    )


class RouteOverflowError(RuntimeError):
    """All-to-all dispatch overflowed its capacity — retry with a larger
    route_capacity_factor (cfg) or a bigger batch split."""


@dataclasses.dataclass
class ShardedBuildState:
    """In-flight streaming build, one entry a shard (``[r][t]``): staging accumulators, the
    route-overflow total (the same global sum on every shard) and the row-partial tables."""

    acc: list  # [R][T] KmerAccumulator
    ovf: list  # [R][T] () int64
    table: list  # [R][T] KmerTable or ScoreTable
    pending: int  # batches staged since the last route


class ShardedKmerEngine:
    """The sharded ops of one (cfg, mesh) pair. Reusable across samples and batches.

    ``n_passes > 1``: the time-multiplexed hash-pass partition — ingest keeps only k-mers
    whose ``router.pass_of`` bucket is the ``pass_id`` given; ``pass_of`` uses another hash
    basis than ``owner_of``, so every pass fills all T shards. ``overlap_route``: route a full
    window on the next ingest, before its extraction (see the module docstring)."""

    def __init__(self, cfg: EngineConfig, mesh: Mesh, n_passes: int = 1,
                 overlap_route: bool = True):
        self.cfg, self.mesh, self.n_passes = cfg, mesh, n_passes
        self.R = mesh.shape[AXIS_READS]
        self.T = mesh.shape[AXIS_TABLE]
        n_dev = self.R * self.T
        if cfg.batch_reads % n_dev:
            raise ValueError(
                f"batch_reads ({cfg.batch_reads}) must be divisible by mesh size {n_dev}"
            )
        self.local_reads = cfg.batch_reads // n_dev
        self.local_kmers = self.local_reads * cfg.windows_per_read
        # the route runs once a window, so its capacity covers accum_batches batches
        self.acc_slots = cfg.accum_batches * self.local_kmers
        self.route_cap = route_capacity(self.acc_slots, self.T, cfg.route_capacity_factor)
        self.shard_capacity = -(-cfg.table_capacity // self.T)
        self.W = cfg.words
        self._overlap_route = overlap_route
        self._spill_cache = {}

    # ---------- per-shard helpers ----------

    @property
    def feed_device(self) -> torch.device:
        """Where a batch lands before it splits over the shards: this process's first mesh
        device."""
        return self.mesh.device(*self.mesh.local_cells()[0])

    def _grid(self, fn) -> list:
        """``[[fn(r, t, device of (r, t)) for t] for r]`` over this process's cells; None
        on the others."""
        return [[fn(r, t, self.mesh.device(r, t)) if self.mesh.is_local(r, t) else None
                 for t in range(self.T)] for r in range(self.R)]

    def _local(self, grid) -> list:
        """The entries of this process's cells."""
        return [grid[r][t] for r, t in self.mesh.local_cells()]

    def _reduce(self, xs, op: str) -> int:
        """Max or sum of 0-dim tensors of this process's cells, over every rank."""
        dev = self.feed_device
        x = torch.stack([v.to(dev) for v in xs])
        return reduce_host(self.mesh, int(x.max() if op == "max" else x.sum()), op)

    def _max_n(self, tables) -> int:
        return self._reduce([tab.n for tab in self._local(tables)], "max")

    def _sum_n(self, tables) -> int:
        return self._reduce([tab.n for tab in self._local(tables)], "sum")

    def _needs_replicated(self, replicated_fetch: bool) -> None:
        if self.mesh.spans_processes and not replicated_fetch:
            raise ValueError("a mesh that spans processes needs replicated_fetch=True: "
                             "shard (0, 0) may belong to another rank")

    def _route_window(self, accs):
        """Bucket every shard's staged window by owner shard and exchange the buckets over
        the table axis. → (per-shard (rows (T·cap, W) int32, valid), the overflow summed
        over both axes on every shard)."""
        T, W, cap = self.T, self.W, self.route_cap
        parts = self._grid(lambda r, t, d: bucketize(
            accs[r][t].kmers, staged_valid(accs[r][t]), T, cap))
        recv = all_to_all(self.mesh, _field(parts, 0))
        rmask = all_to_all(self.mesh, _field(parts, 1))
        ovf = psum(self.mesh, _field(parts, 3))
        routed = self._grid(lambda r, t, d: (recv[r][t].reshape(-1, W),
                                             rmask[r][t].reshape(-1)))
        return routed, ovf

    def _fold_window(self, ltab, rk, rv):
        """Fold routed window rows into a shard's row-partial table as a flush folds its
        staging window: ``ops/stream.flush`` into a KmerTable, ``ops/score.flush_score``
        into a ScoreTable (routed rows weigh 1 and carry pcounts 0, as staged rows do)."""
        step = flush_score_table if isinstance(ltab, ScoreTable) else flush_table
        return step(KmerAccumulator(kmers=rk, valid=rv, fill=rk.shape[0]), ltab)[1]

    def _extract(self, acc: KmerAccumulator, block, pass_id: int) -> KmerAccumulator:
        """Append one shard's block of a batch to its staging buffer. The extraction width
        comes from the batch shape (length-bucketed batches arrive narrower). A ``None``
        block is a multi-process padding step (``distributed.make_global_batch`` of an empty
        batch): it holds no read, so nothing is staged."""
        if block is None:
            return acc
        words, vwords, lengths = block
        eff_len = min(words.shape[1] * 16, self.cfg.max_read_len)
        return extract_append(acc, words, vwords, lengths, self.cfg.k, eff_len,
                              self.cfg.canonical, self.n_passes, pass_id)

    def flush(self, state: ShardedBuildState) -> ShardedBuildState:
        """Route the staged window and fold it into the row partials; reset the staging."""
        routed, ovf = self._route_window(state.acc)
        table = self._grid(lambda r, t, d: self._fold_window(state.table[r][t],
                                                             *routed[r][t]))
        return ShardedBuildState(
            acc=self._grid(lambda r, t, d: state.acc[r][t]._replace(fill=0)),
            ovf=self._grid(lambda r, t, d: state.ovf[r][t] + ovf[r][t]),
            table=table, pending=0)

    def _flush_ingest(self, state: ShardedBuildState, blocks,
                      pass_id: int) -> ShardedBuildState:
        """Route the full window, then extract the new batch into the emptied buffers (the
        routed rows are already copied out), then fold: the JAX fused flush+ingest."""
        routed, ovf = self._route_window(state.acc)
        acc = self._grid(lambda r, t, d: self._extract(
            state.acc[r][t]._replace(fill=0), blocks[r][t], pass_id))
        table = self._grid(lambda r, t, d: self._fold_window(state.table[r][t],
                                                             *routed[r][t]))
        return ShardedBuildState(
            acc=acc, ovf=self._grid(lambda r, t, d: state.ovf[r][t] + ovf[r][t]),
            table=table, pending=1)

    def ingest_global(self, state: ShardedBuildState, blocks,
                      pass_id: int = 0) -> ShardedBuildState:
        """``ingest`` of a batch already split by ``put_batch`` (several engines on one mesh
        share one placement: the multi-k sweep)."""
        if self._overlap_route and state.pending >= self.cfg.accum_batches:
            return self._flush_ingest(state, blocks, pass_id)
        acc = self._grid(lambda r, t, d: self._extract(state.acc[r][t], blocks[r][t],
                                                       pass_id))
        state = ShardedBuildState(acc=acc, ovf=state.ovf, table=state.table,
                                  pending=state.pending + 1)
        if not self._overlap_route and state.pending >= self.cfg.accum_batches:
            state = self.flush(state)
        return state

    def _check_route(self, state: ShardedBuildState, replicated_fetch: bool = False) -> None:
        # every shard holds the global total (the route psums over both axes)
        self._needs_replicated(replicated_fetch)
        ovf_val = self._reduce(self._local(state.ovf), "max")
        if ovf_val:
            raise RouteOverflowError(
                f"{ovf_val} k-mers overflowed route capacity {self.route_cap}; "
                f"increase route_capacity_factor (={self.cfg.route_capacity_factor})"
            )

    def _gathered(self, tables) -> list:
        """Per shard: its column's R row partials gathered over the reads axis, (keys
        (R, C, W), [weight columns (R, C)], n (R,))."""
        scored = isinstance(self._local(tables)[0], ScoreTable)
        cols = ["counts", "pcounts"] if scored else ["counts"]
        g = {name: all_gather(self.mesh, _attr(tables, name)) for name in ["keys", "n"] + cols}
        return self._grid(lambda r, t, d: (g["keys"][r][t], [g[c][r][t] for c in cols],
                                           g["n"][r][t]))

    def _finalize_tables(self, tables) -> list:
        """Fold each column's row partials so every row holds the full shard: each partial
        is sorted and unique, so they merge in pairs (``_merge_sorted``), every merge but
        the last at its inputs' rows together. Nothing is dropped before the last merge, so
        ``n`` is the union's size, as one aggregate of the R·C rows gives it; an overflow of
        any partial stays sticky."""
        C = self.shard_capacity

        def fold(keys, cols, n_all):
            parts = [(keys[r], [c[r] for c in cols], n_all[r].clamp(max=C))
                     for r in range(self.R)]
            while len(parts) > 1:
                last = len(parts) == 2
                odd = parts[-1:] if len(parts) % 2 else []
                parts = [_merge_sorted(ak, an, ac, bk, bn, bc,
                                       C if last else ak.shape[0] + bk.shape[0])
                         for (ak, ac, an), (bk, bc, bn) in zip(parts[::2], parts[1::2])] + odd
            out_keys, out_cols, n = parts[0]
            n = _sticky_overflow_n(n, C, (n_all > C).any())
            if len(out_cols) == 1:
                return KmerTable(keys=out_keys, counts=out_cols[0], n=n)
            return ScoreTable(keys=out_keys, counts=out_cols[0], pcounts=out_cols[1], n=n)

        g = self._gathered(tables)
        return self._grid(lambda r, t, d: fold(*g[r][t]))

    # ---------- the single-decode multipass (the mesh twin of ops/spill.py) ----------

    def spill_programs(self, n_spill: int, rows_pp: int, capacity_factor: float = 1.4):
        """The program set of the SHARDED single-decode multipass: each shard partitions its
        own staged window by ``router.pass_of`` (``router.bucketize``, as the JAX engine
        does) into per-pass row blocks kept in a per-shard device store, and each counting
        pass folds only its own rows through the engine's route + aggregate.

        ``rows_pp``: store rows PER PASS PER SHARD (rounded up to a multiple of the staging
        window). Returns a namespace with (new_store, partition, append, fold, chunk_rows,
        rows_pp, window_cap); ``fold`` takes a table or a score table."""
        S, W, Pp = self.acc_slots, self.W, n_spill
        rows_pp = -(-rows_pp // S) * S
        key = (n_spill, rows_pp, capacity_factor)
        if key in self._spill_cache:
            return self._spill_cache[key]
        cap = route_capacity(S, Pp, capacity_factor)
        # +1 window-cap of slack a pass (ops/spill.PassStore): the append never clamps
        # while the logical fill guard can still fire; a multiple of S keeps chunks whole
        rows_alloc = rows_pp + -(-cap // S) * S

        def new_store():
            return (self._grid(lambda r, t, d: torch.zeros((Pp, rows_alloc, W),
                                                            dtype=torch.int32, device=d)),
                    self._grid(lambda r, t, d: torch.zeros((Pp,), dtype=torch.int64,
                                                            device=d)))

        def partition(accs, ovf):
            def one(r, t, d):
                acc = accs[r][t]
                owner = pass_of(acc.kmers, Pp)
                disp, mask, _src, o = bucketize(acc.kmers, staged_valid(acc), Pp, cap,
                                                owner=owner)
                return disp, mask.sum(dim=1), acc._replace(fill=0), ovf[r][t] + o

            parts = self._grid(one)
            return tuple(_field(parts, i) for i in range(4))

        def append(rows, fill, disp, counts):
            def one(r, t, d):
                # JAX's dynamic_update_slice: a start that would run past the end is clamped
                start = fill[r][t].clamp(max=rows_alloc - cap)
                idx = ((torch.arange(Pp, device=d) * rows_alloc + start)[:, None]
                       + torch.arange(cap, device=d)[None, :])
                rows[r][t].view(Pp * rows_alloc, W).index_copy_(
                    0, idx.reshape(-1), disp[r][t].reshape(-1, W))
                return fill[r][t] + counts[r][t]

            return rows, self._grid(one)

        def chunk_accs(rows, fill, p, start):
            def one(r, t, d):
                nv = (fill[r][t][p] - start).clamp(0, S)
                valid = torch.arange(S, device=d) < nv
                return KmerAccumulator(kmers=rows[r][t][p, start:start + S], valid=valid,
                                       fill=S)

            return self._grid(one)

        def fold(rows, fill, tab, ovf, p, start):
            """Fold pass ``p``'s store rows from ``start`` into ``tab`` (a table or a score
            table) through the route."""
            routed, o = self._route_window(chunk_accs(rows, fill, p, start))
            return (self._grid(lambda r, t, d: self._fold_window(tab[r][t], *routed[r][t])),
                    self._grid(lambda r, t, d: ovf[r][t] + o[r][t]))

        ns = types.SimpleNamespace(
            new_store=new_store, partition=partition, append=append, fold=fold,
            chunk_rows=S, rows_pp=rows_pp, window_cap=cap,
        )
        self._spill_cache[key] = ns
        return ns

    # ---------- host API ----------

    def empty_table(self) -> list:
        """An empty engine-layout table: one empty shard table a device."""
        return self._grid(lambda r, t, d: empty_table(self.shard_capacity, self.W, d))

    def zeros_ovf(self) -> list:
        return self._grid(lambda r, t, d: torch.zeros((), dtype=torch.int64, device=d))

    def new_acc_state(self):
        """(staging accumulators, route-overflow counters), one a shard."""
        return (self._grid(lambda r, t, d: empty_accumulator(self.acc_slots, self.W, d)),
                self.zeros_ovf())

    def new_build(self) -> ShardedBuildState:
        acc, ovf = self.new_acc_state()
        return ShardedBuildState(acc=acc, ovf=ovf, table=self.empty_table(), pending=0)

    def put_batch(self, packed) -> list:
        """A batch's per-shard blocks ``(words, vwords, lengths)`` on each shard's device:
        block ``r·T + t`` of ``batch_reads / (R·T)`` reads. Prefix-valid batches ship
        lengths (``vwords`` None); the others their validity words. On a mesh that spans
        processes ``packed`` is this rank's share, split over its own cells in order."""
        cells = self.mesh.local_cells()
        n_dev = len(cells)

        def tensor(a):
            return a if isinstance(a, torch.Tensor) else as_int32_tensor(np.asarray(a))

        words = tensor(packed.words)
        B = words.shape[0]
        if B % n_dev:
            raise ValueError(f"a batch of {B} reads does not split over {n_dev} shards")
        lr = B // n_dev
        if getattr(packed, "prefix_valid", False) or packed.vwords is None:
            lens = packed.length
            if not isinstance(lens, torch.Tensor):
                lens = as_int32_tensor(np.ascontiguousarray(lens, dtype=np.int32))
            vwords = None
        else:
            vwords, lens = tensor(packed.vwords), None

        def block(r, t, d):
            i = cells.index((r, t))
            sl = slice(i * lr, (i + 1) * lr)
            return (words[sl].to(d, non_blocking=True),
                    None if vwords is None else vwords[sl].to(d, non_blocking=True),
                    None if lens is None else lens[sl].to(d, non_blocking=True))

        return self._grid(block)

    def ingest(self, state: ShardedBuildState, packed, pass_id: int = 0) -> ShardedBuildState:
        """Extract and stage one batch on every shard; a full window is routed by the next
        ingest (``overlap_route``) or right away, and the remainder at finalize. No host
        sync: the overflow counters are read once, at finalize. The state's table picks the
        fold: a build (``new_build``) or a scored child (``new_score_build``)."""
        return self.ingest_global(state, self.put_batch(packed), pass_id)

    # the JAX engine's names for the scored child: the table in the state picks the fold
    ingest_score = ingest
    ingest_score_global = ingest_global
    flush_score = flush

    def finalize(self, state: ShardedBuildState, replicated_fetch: bool = False) -> list:
        """Route the remainder, check the overflow, fold the row partials.
        ``replicated_fetch`` reduces the host-checked values over the ranks first: required
        when the mesh spans processes."""
        if state.pending:
            state = self.flush(state)
        self._check_route(state, replicated_fetch)
        table = self._finalize_tables(state.table)
        n_max = self._max_n(table)
        if n_max > self.shard_capacity:
            raise RuntimeError(
                f"table shard overflow: {n_max} uniques > shard capacity "
                f"{self.shard_capacity}; raise --table-capacity"
            )
        return table

    # ---------- engine-layout checkpoints ----------

    def table_arrays(self, table) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row 0 of an engine-layout table on the host (rows are replicas after finalize):
        uint32 keys (T, C, W), uint32 counts (T, C), int32 n (T,). Collective when the mesh
        spans processes: every rank gets the whole row."""
        cells = [(0, t) for t in range(self.T)]

        def row(name):
            got = gather_cells(self.mesh, _attr(table, name), cells)
            return [got[c].cpu().numpy() for c in cells]

        return (np.stack(row("keys")).astype(np.uint32),
                np.stack(row("counts")).astype(np.uint32),
                np.array([int(x) for x in row("n")], dtype=np.int32))

    def save_table(self, path: str, table, source: Optional[str] = None,
                   write: bool = True, backend: str = "npz") -> None:
        """Persist a finalized sharded table in the JAX engine's layout: one npz with
        ``keys`` (T, C, W), ``counts`` (T, C), ``n`` (T,) and the JSON ``meta``
        (``backend="orbax"``: the orbax directory of ``utils/checkpoint_orbax.py``).

        Collective when the mesh spans processes: every rank calls it with the same table
        and the table is gathered; only the rank given ``write=True`` writes (pass
        ``write=rank == 0``)."""
        _check_backend(backend)
        if backend == "orbax":
            from denovo_kmer_tpu_torch.utils.checkpoint_orbax import save_table_orbax

            save_table_orbax(path, self.engine_arrays(table), self.cfg, source=source,
                             write=write)
            return
        keys, counts, n = self.table_arrays(table)
        if not write:
            return
        meta = {
            "format_version": 1,
            "config_hash": self.cfg.config_hash(),
            "T": self.T,
            "shard_capacity": self.shard_capacity,
            "words": self.W,
            "source": source,
        }
        np.savez_compressed(path, keys=keys, counts=counts, n=n,
                            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))

    def engine_arrays(self, table) -> dict:
        """The JAX engine's global arrays of a finalized table: keys (R, T, C, W), counts
        (R, T, C), n (R, T), rows replicated (collective, like ``table_arrays``)."""
        keys, counts, n = self.table_arrays(table)
        R = self.R
        return {"keys": np.broadcast_to(keys[None], (R,) + keys.shape),
                "counts": np.broadcast_to(counts[None], (R,) + counts.shape),
                "n": np.broadcast_to(n[None], (R,) + n.shape)}

    def place_arrays(self, keys: np.ndarray, counts: np.ndarray, n: np.ndarray) -> list:
        """An engine-layout table from host (T, C, W) keys, (T, C) counts and (T,) n: shard
        t on every row of column t (replicated rows, the finalize invariant); each process
        places its own cells only."""
        return self._grid(lambda r, t, d: table_from_numpy(keys[t], counts[t], n[t], d))

    def load_table(self, path: str, backend: str = "npz") -> list:
        """Load an engine-layout checkpoint; validates the semantics hash and the shard
        geometry. Each process places its own cells."""
        from denovo_kmer_tpu_torch.utils.checkpoint import CheckpointError

        _check_backend(backend)
        if backend == "orbax":
            from denovo_kmer_tpu_torch.utils.checkpoint_orbax import load_arrays_orbax

            arrs = load_arrays_orbax(path, self.cfg)
            want = (self.R, self.T, self.shard_capacity, self.W)
            if tuple(arrs["keys"].shape) != want:
                raise CheckpointError(f"shard geometry mismatch: saved keys "
                                      f"{tuple(arrs['keys'].shape)}, engine {want}")
            # rows are replicas (the finalize invariant): row 0 places every row
            return self.place_arrays(arrs["keys"][0], arrs["counts"][0], arrs["n"][0])
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            keys, counts, n = z["keys"], z["counts"], z["n"]
        if meta["config_hash"] != self.cfg.config_hash():
            raise CheckpointError(
                f"checkpoint semantics mismatch: saved {meta['config_hash']}, "
                f"current {self.cfg.config_hash()}"
            )
        if meta["T"] != self.T or meta["shard_capacity"] != self.shard_capacity:
            raise CheckpointError(
                f"shard geometry mismatch: saved T={meta['T']} C={meta['shard_capacity']}, "
                f"engine T={self.T} C={self.shard_capacity}"
            )
        return self.place_arrays(keys, counts, n)

    def place_flat_table(self, table: KmerTable) -> list:
        """Hash-partition a single-device table (e.g. a `count` .npz checkpoint) into the
        engine layout. The input is sorted, so each shard's subset stays sorted."""
        T, C, W = self.T, self.shard_capacity, self.W
        n = int(table.n)
        keys = table.keys[:n].cpu().numpy().astype(np.uint32)
        counts = table.counts[:n].cpu().numpy().astype(np.uint32)
        owners = (owner_of(torch.from_numpy(keys.astype(np.int64)), T).numpy()
                  if n else np.zeros(0, np.int32))
        k_out = np.full((T, C, W), PAD, np.uint32)
        c_out = np.zeros((T, C), np.uint32)
        n_out = np.zeros((T,), np.int32)
        # one stable owner sort keeps key order within each shard
        order = np.argsort(owners, kind="stable")
        per = np.bincount(owners, minlength=T) if n else np.zeros(T, np.int64)
        if per.max(initial=0) > C:
            t_bad = int(per.argmax())
            raise RuntimeError(
                f"flat table shard {t_bad} holds {int(per[t_bad])} uniques > shard "
                f"capacity {C}; raise --table-capacity"
            )
        starts = np.concatenate([[0], np.cumsum(per)])
        ks, cs = keys[order], counts[order]
        for t in range(T):
            m = int(per[t])
            k_out[t, :m] = ks[starts[t]:starts[t] + m]
            c_out[t, :m] = cs[starts[t]:starts[t] + m]
            n_out[t] = m
        return self.place_arrays(k_out, c_out, n_out)

    def merge_sharded_tables(self, a: list, b: list) -> list:
        """Shard-local count merge of two finalized sharded tables (one owner function
        everywhere, so no communication): the cohort's parental superset."""
        C = self.shard_capacity
        return self._grid(lambda r, t, d: merge_tables(a[r][t], b[r][t], C))

    # ---------- the scored child build and the trio call ----------

    def seed_score(self, mom: list, dad: list) -> list:
        """Parent-seeded score tables, on row 0 only (the finalize sums row partials, so
        seeding every row would multiply the parental packs by R)."""
        C, W = self.shard_capacity, self.W
        return self._grid(lambda r, t, d: seed_score_table(mom[r][t], dad[r][t], C)
                          if r == 0 else empty_score_table(C, W, d))

    def new_score_build(self, mom: list, dad: list) -> ShardedBuildState:
        acc, ovf = self.new_acc_state()
        return ShardedBuildState(acc=acc, ovf=ovf, table=self.seed_score(mom, dad),
                                 pending=0)

    def finalize_score(self, state: ShardedBuildState, replicated_fetch: bool = False) -> list:
        if state.pending:
            state = self.flush_score(state)
        self._check_route(state, replicated_fetch)
        stab = self._finalize_tables(state.table)
        n_max = self._max_n(stab)
        if n_max > self.shard_capacity:
            raise RuntimeError(_sharded_overflow_msg(n_max, self.shard_capacity))
        return stab

    def finalize_call_score(self, state: ShardedBuildState, replicated_fetch: bool = False):
        """Fused finalize + candidate call over the scored build state: per shard, one key
        sort of the gathered row partials and exact group sums (``ops/fused.call_rows``).
        Returns (candidate tuples sorted by k-mer value, n_child_unique), the same on every
        rank. Even k (padding-key collision) falls back to ``finalize_score`` +
        ``call_score``."""
        if state.pending:
            state = self.flush_score(state)
        self._check_route(state, replicated_fetch)
        n_max = self._max_n(state.table)
        if n_max > self.shard_capacity:
            raise RuntimeError(_sharded_overflow_msg(n_max, self.shard_capacity))

        if not fused_supported(self.cfg.k):
            stab = self._finalize_tables(state.table)
            # the folded union of a shard can exceed C where every row partial fit
            n_fold = self._max_n(stab)
            if n_fold > self.shard_capacity:
                raise RuntimeError(_sharded_overflow_msg(n_fold, self.shard_capacity))
            nchild = self._reduce([(tab.counts != 0).sum() for tab in self._local(stab)],
                                  "sum")
            return self.call_score(stab, replicated_fetch), nchild // self.R

        cfg = self.cfg
        W = self.W

        def call(keys, cols, n_all):
            R, C = keys.shape[:2]
            valid = (torch.arange(C, device=keys.device)[None, :] < n_all[:, None]).reshape(-1)
            keys = keys.reshape(R * C, W)
            words = [torch.where(valid, u32(keys[:, w]), PAD) for w in range(W)]
            cnt = torch.where(valid, cols[0].reshape(-1), 0)
            pc = torch.where(valid, cols[1].reshape(-1), 0)
            return call_rows(words, cnt, pc, cfg.tau_parent, cfg.min_child_count)

        g = self._gathered(state.table)
        res = self._grid(lambda r, t, d: call(*g[r][t]))
        nchild = self._reduce([torch.as_tensor(x[5]) for x in self._local(res)], "sum")
        return self._row0_tuples(res), nchild // self.R

    def _row0_tuples(self, res) -> List[Tuple[int, int, int, int]]:
        """Host tuples of row 0's per-shard candidate columns (rows are replicas), sorted by
        k-mer value; on a mesh that spans processes each rank contributes the row-0 cells it
        owns and every rank gets the union."""
        mine = _tuples([res[0][t] for t in range(self.T) if self.mesh.is_local(0, t)])
        out = [x for part in gather_objects(self.mesh, mine) for x in part]
        out.sort()
        return out

    def call_score(self, stab: list,
                   replicated_fetch: bool = False) -> List[Tuple[int, int, int, int]]:
        """Candidate call over a finalized sharded scoring table: host tuples sorted
        ascending by k-mer value (the same on every rank)."""
        self._needs_replicated(replicated_fetch)
        tau, minc = self.cfg.tau_parent, self.cfg.min_child_count
        cands = self._grid(lambda r, t, d: _compacted(call_from_score(stab[r][t], tau, minc)))
        return self._row0_tuples(cands)

    def total_unique(self, table: list) -> int:
        """Total uniques across shards (rows are replicas after finalize)."""
        return self._sum_n(table) // self.R

    def call(self, child: list, mom: list, dad: list) -> List[Tuple[int, int, int, int]]:
        """The shard-local three-table call (``ops/trio.call_candidates``): host tuples
        sorted ascending by k-mer value."""
        tau, minc = self.cfg.tau_parent, self.cfg.min_child_count
        cands = self._grid(lambda r, t, d: _compacted(call_candidates(
            child[r][t], mom[r][t], dad[r][t], tau, minc)))
        return self._row0_tuples(cands)


def _check_backend(backend: str) -> None:
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r}: 'npz' or 'orbax'")


def _field(grid, i) -> list:
    """Field ``i`` of every entry of a per-shard grid of tuples (None stays None)."""
    return [[None if x is None else x[i] for x in row] for row in grid]


def _attr(grid, name) -> list:
    """Attribute ``name`` of every entry of a per-shard grid (None stays None)."""
    return [[None if x is None else getattr(x, name) for x in row] for row in grid]


def _compacted(c):
    """The first ``n`` rows of a Candidates: (keys, child, mom, dad)."""
    n = int(c.n)
    return c.keys[:n], c.child_counts[:n], c.mom_counts[:n], c.dad_counts[:n]


def _tuples(shard_cands) -> List[Tuple[int, int, int, int]]:
    """Host tuples (kmer_value, child, mom, dad) of a row's per-shard candidate columns,
    sorted ascending by k-mer value (shards hold disjoint keys)."""
    out = []
    for keys, cc, mc, dc, *_ in shard_cands:
        keys = keys.cpu().numpy().astype(np.uint32)
        cc, mc, dc = (x.cpu().numpy().astype(np.uint32) for x in (cc, mc, dc))
        out.extend((words_to_kmer_value(keys[i]), int(cc[i]), int(mc[i]), int(dc[i]))
                   for i in range(keys.shape[0]))
    out.sort()
    return out
