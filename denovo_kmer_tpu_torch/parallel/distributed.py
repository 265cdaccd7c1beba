"""Multi-process execution over ``torch.distributed``.

Port of ``denovo_kmer_tpu/parallel/distributed.py``:
- process bootstrap through ``torch.distributed.init_process_group`` (arguments, or the env
  vars JAX's reads, so one launcher serves both packages);
- the mesh spans all processes (``parallel/mesh.make_mesh``); each process feeds its *local*
  share of every global batch, split over its own cells (``make_global_batch``);
- read-stream distribution is plain per-process record striping (record i goes to process
  i mod n), or the BAM's virtual-offset ranges (each process decodes only its range).

Everything downstream (route, table shards, candidate call) is the same
``ShardedKmerEngine`` program; its collectives cross ranks on the backend named at
initialisation (gloo through the host, NCCL on the cards).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.pack import PackedReads, pack_records, pack_seqs
from denovo_kmer_tpu_torch.utils.device import resolve_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join the process group at ``tcp://<coordinator_address>`` (``host:port``). The
    arguments default to JAX's env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). ``backend`` defaults to the card's, ``nccl`` (without a card that
    raises, as every entry point's default device does); name ``gloo`` for ranks on the CPU
    or to stage through the host. The one named is the one used. ``timeout``: seconds a
    collective waits for a peer (torch's default when None)."""
    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if addr is None or n is None or pid is None:
        raise ValueError("initialize_distributed needs the coordinator address, the number "
                         "of processes and this process's id (arguments or "
                         "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)")
    if backend is None:
        resolve_device(None)
        backend = "nccl"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=int(n),
                            rank=int(pid), **kwargs)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_allgather(value: int) -> np.ndarray:
    """Every process's integer, in rank order (JAX's ``multihost_utils.process_allgather``
    of a one-element array)."""
    import torch.distributed as dist

    if process_count() == 1:
        return np.array([int(value)], dtype=np.int64)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    x = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    out = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(out, x)
    return torch.cat(out).cpu().numpy()


def sync_global_devices(name: str = "") -> None:
    """Barrier over every process (JAX's ``multihost_utils.sync_global_devices``)."""
    import torch.distributed as dist

    if process_count() > 1:
        dist.barrier()


def striped_records(records: Iterable, host_id: int, n_hosts: int) -> Iterator:
    """Deterministic record striping: host h keeps records with index ≡ h (mod n_hosts).

    The union over hosts is exactly the input stream, so global results are bit-identical to
    single-host (counting is order-independent)."""
    return itertools.islice(records, host_id, None, n_hosts)


def _local_cfg(cfg: EngineConfig, n_hosts: int) -> EngineConfig:
    if cfg.batch_reads % n_hosts:
        raise ValueError(
            f"batch_reads ({cfg.batch_reads}) must divide by n_hosts ({n_hosts})"
        )
    return dataclasses.replace(cfg, batch_reads=cfg.batch_reads // n_hosts)


def host_packed_stream(
    path_records: Iterable,
    cfg: EngineConfig,
    host_id: int,
    n_hosts: int,
) -> Iterator[PackedReads]:
    """This host's packed sub-batches: stripe records, pack B/n_hosts reads per batch so that
    the concatenation over hosts forms the global batch of cfg.batch_reads."""
    local_cfg = _local_cfg(cfg, n_hosts)
    return pack_records(striped_records(path_records, host_id, n_hosts), local_cfg)


def ranged_host_records(path: str, host_id: int, n_hosts: int, splits=None):
    """This host's record RANGE of a BAM via virtual offsets: unlike striping, each host
    decodes only ~1/n_hosts of the file. ``splits``: precomputed
    ``scan_split_offsets(path, n_hosts)``; computed locally when omitted (each host then
    pays one scan, still correct).

    Counting is order-independent and the ranges partition the stream exactly, so results
    are bit-identical to striping and to single-host."""
    from denovo_kmer_tpu_torch.io.bam import read_bam_records_range, scan_split_offsets

    if splits is None:
        splits = scan_split_offsets(path, n_hosts)
    return read_bam_records_range(path, splits[host_id], splits[host_id + 1])


def host_packed_stream_ranged(
    path: str,
    cfg: EngineConfig,
    host_id: int,
    n_hosts: int,
    splits=None,
) -> Iterator[PackedReads]:
    """Range-sharded variant of ``host_packed_stream`` (BAM paths only)."""
    local_cfg = _local_cfg(cfg, n_hosts)
    return pack_records(ranged_host_records(path, host_id, n_hosts, splits), local_cfg)


def make_global_batch(engine, local_packed: PackedReads) -> list:
    """This process's share of one step, split over its own cells: the per-shard block
    grid of ``engine.put_batch`` (other ranks' cells None). A padding batch (no read,
    ``steps_aligned`` / ``steps_fixed``) gives None blocks: the ingest stages nothing for
    it, while its collectives run as on every other rank."""
    if local_packed.n_reads == 0:
        return engine._grid(lambda r, t, d: None)
    return engine.put_batch(local_packed)


def _empty_local_batch(cfg: EngineConfig) -> PackedReads:
    local_cfg = dataclasses.replace(cfg, batch_reads=cfg.batch_reads // process_count())
    return pack_seqs([], local_cfg, batch_size=local_cfg.batch_reads)


def steps_aligned(
    host_batches: Iterator[PackedReads], cfg: EngineConfig, sync_every: int = 16
):
    """Multi-host streams must take the SAME number of ingest steps on every host (SPMD).
    Yield local batches followed by empty padding batches until all hosts are done.

    Synchronization is CHUNKED: hosts run ``sync_every`` steps collective-free, padding
    locally once exhausted, and one allgather per chunk decides termination. Padding
    batches are empty, so results stay bit-identical; the cost is at most one fully-padded
    trailing chunk. For range-sharded BAM feeding use ``steps_fixed`` instead: zero
    collectives."""
    empty = None
    it = iter(host_batches)
    exhausted = False
    while True:
        produced = 0
        for _ in range(sync_every):
            batch = None if exhausted else next(it, None)
            if batch is None:
                exhausted = True
                if empty is None:
                    empty = _empty_local_batch(cfg)
                batch = empty
            else:
                produced += 1
            yield batch
        if not process_allgather(produced).max():
            return


def steps_fixed(
    host_batches: Iterator[PackedReads], cfg: EngineConfig, n_steps: int
):
    """Collective-free step alignment: every host yields exactly ``n_steps`` batches (its
    real ones first, empty padding after). ``n_steps`` must be derived identically on every
    host, e.g. ``max_h ceil(raw_range_records_h / local_batch)`` from one
    ``scan_split_offsets(..., return_counts=True)`` pass (raw counts upper-bound the
    flag-filtered batch count, so padding absorbs the difference). Raises if a host holds
    more batches than ``n_steps`` (a split/step-count mismatch would silently drop reads)."""
    empty = None
    it = iter(host_batches)
    done = False
    for _ in range(n_steps):
        batch = None if done else next(it, None)
        if batch is None:
            done = True
            if empty is None:
                empty = _empty_local_batch(cfg)
            batch = empty
        yield batch
    if not done and next(it, None) is not None:
        raise RuntimeError(
            f"host stream exceeds the fixed step count {n_steps} — "
            "n_steps must upper-bound every host's batch count"
        )


def range_step_count(path: str, cfg: EngineConfig, n_hosts: int):
    """(splits, n_steps) for collective-free range feeding: one scan pass, deterministic
    on every host (same file, same math)."""
    from denovo_kmer_tpu_torch.io.bam import scan_split_offsets

    splits, counts = scan_split_offsets(path, n_hosts, return_counts=True)
    local_batch = cfg.batch_reads // n_hosts
    n_steps = max(-(-c // local_batch) for c in counts) if counts else 0
    return splits, n_steps
