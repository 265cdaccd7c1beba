"""Sharded bulk membership probe: all-to-all dispatch, and the ring fallback.

Port of ``denovo_kmer_tpu/parallel/probe.py``. Two probe plans behind one interface:

- ``plan="alltoall"``: bucket the queries by owner shard (``router.bucketize``), exchange the
  buckets over the table axis, probe shard-locally (``ops.join.probe_table_sorted``), send the
  counts back and restore query order. One probe a query; needs a capacity factor and can
  overflow under hash skew (the overflow is counted and returned, never hidden).
- ``plan="ring"``: rotate each shard's query block around the table axis; at each of the T
  steps every shard adds its local matches to the visiting block. T times the probe work, but
  no capacity factor and no overflow: immune to skew.

Both equal the single-device ``ops.table.probe_table``. One controller runs the per-shard
bodies over per-shard lists (``parallel/mesh.py``); a body that the JAX package writes around a
collective is split at it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from denovo_kmer_tpu_torch.ops.join import probe_table_sorted
from denovo_kmer_tpu_torch.ops.table import KmerTable, _aggregate_multi, u32
from denovo_kmer_tpu_torch.parallel.mesh import AXIS_READS, AXIS_TABLE, Mesh, all_to_all, psum
from denovo_kmer_tpu_torch.parallel.router import bucketize, route_capacity


def _probe_local(shard: KmerTable, q: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, probe_table_sorted(shard, q), 0)


def unbucketize_counts(
    back: torch.Tensor,  # (T, cap) probe result of each dispatch slot
    mask: torch.Tensor,  # (T, cap) bool
    src: torch.Tensor,  # (T, cap) original query row of each slot (-1 masked)
    n_queries: int,
) -> torch.Tensor:
    """Results back in original query order, by sort + segment sum: each slot carries its
    query row in ``src``, and one zero-weight filler row a query index makes every index a
    group, so the aggregate's first ``n_queries`` groups are the queries in order. Invalid and
    overflowed queries get 0."""
    N = n_queries
    dev = back.device
    m = mask.reshape(-1)
    keys = torch.cat([torch.where(m, src.reshape(-1).to(torch.int64), N),
                      torch.arange(N, dtype=torch.int64, device=dev)])[:, None]
    vals = torch.cat([torch.where(m, back.reshape(-1), 0),
                      torch.zeros((N,), dtype=torch.int64, device=dev)])
    valid = torch.ones((keys.shape[0],), dtype=torch.bool, device=dev)
    _k, cols, _n = _aggregate_multi(keys, [vals], valid, N)
    return u32(cols[0])


def probe_shard_alltoall(
    mesh: Mesh,
    shards: list,  # [R][T] KmerTable
    queries: list,  # [R][T] (n, W) local queries
    valid: list,  # [R][T] (n,) bool
    num_shards: int,
    capacity: int,
) -> Tuple[list, list]:
    """The per-shard bodies of the all-to-all plan → (counts [R][T] (n,), overflow [R][T]
    summed over the table axis). Overflowed queries return 0 AND are counted: callers check
    the overflow and retry with a larger factor."""
    R, T = mesh.devices.shape
    W = queries[0][0].shape[1]
    parts = [[bucketize(queries[r][t], valid[r][t], num_shards, capacity)
              for t in range(T)] for r in range(R)]
    recv = all_to_all(mesh, [[p[0] for p in row] for row in parts])
    rmask = all_to_all(mesh, [[p[1] for p in row] for row in parts])
    counts = [[_probe_local(shards[r][t], recv[r][t].reshape(-1, W),
                            rmask[r][t].reshape(-1)).reshape(num_shards, capacity)
               for t in range(T)] for r in range(R)]
    back = all_to_all(mesh, counts)
    out = [[unbucketize_counts(back[r][t], parts[r][t][1], parts[r][t][2],
                               queries[r][t].shape[0])
            for t in range(T)] for r in range(R)]
    return out, psum(mesh, [[p[3] for p in row] for row in parts], axes=(AXIS_TABLE,))


def probe_shard_ring(
    mesh: Mesh,
    shards: list,  # [R][T] KmerTable
    queries: list,  # [R][T] (n, W) local queries
    valid: list,  # [R][T] (n,) bool
    num_shards: int,
) -> list:
    """The per-shard bodies of the ring plan: T steps, each adding every shard's local
    matches to the visiting (queries, counts) block, then passing each block from table
    position t to t + 1. After T steps every block is home with its summed counts."""
    R, T = mesh.devices.shape
    q = [list(row) for row in queries]
    v = [list(row) for row in valid]
    counts = [[torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device) for x in row]
              for row in queries]
    for _ in range(num_shards):
        counts = [[counts[r][t] + _probe_local(shards[r][t], q[r][t], v[r][t])
                   for t in range(T)] for r in range(R)]

        def rotate(x):
            return [[x[r][(t - 1) % T].to(mesh.device(r, t), non_blocking=True)
                     for t in range(T)] for r in range(R)]

        q, v, counts = rotate(q), rotate(v), rotate(counts)
    return counts


def make_sharded_probe(mesh: Mesh, cfg, plan: str = "alltoall"):
    """Bulk probe over a sharded table: ``fn(table, queries, valid) → (counts, overflow)``.

    ``table``: engine layout ([R][T] KmerTable, rows replicated); ``queries`` (N, W) and
    ``valid`` (N,) split over the mesh flat (block ``r·T + t`` to shard (r, t)). Returns the
    counts (N,) in query order on the first mesh device and the overflow summed over the
    mesh (0-dim; always 0 for the ring)."""
    R, T = mesh.devices.shape
    if plan not in ("alltoall", "ring"):
        raise ValueError(f"unknown probe plan: {plan!r}")

    def probe(table: list, queries: torch.Tensor, valid: torch.Tensor):
        N = queries.shape[0]
        if N % (R * T):
            raise ValueError(f"{N} queries do not split over {R * T} shards")
        n = N // (R * T)

        def split(x):
            return [[x[(r * T + t) * n:(r * T + t + 1) * n].to(mesh.device(r, t))
                     for t in range(T)] for r in range(R)]

        q, v = split(queries), split(valid)
        if plan == "ring":
            counts = probe_shard_ring(mesh, table, q, v, T)
            ovf = [[torch.zeros((), dtype=torch.int64, device=mesh.device(r, t))
                    for t in range(T)] for r in range(R)]
        else:
            cap = route_capacity(n, T, cfg.route_capacity_factor)
            counts, ovf = probe_shard_alltoall(mesh, table, q, v, T, cap)
        # the all-to-all summed over the table axis; the row totals sum over the reads axis
        ovf = psum(mesh, ovf, axes=(AXIS_READS,))
        dev = mesh.device(0, 0)
        out = torch.cat([counts[r][t].to(dev) for r in range(R) for t in range(T)])
        return out, ovf[0][0]

    return probe
