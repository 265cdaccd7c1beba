"""Device mesh (reads × table) and the collectives the sharded engine runs over it.

Port of ``denovo_kmer_tpu/parallel/mesh.py``. The JAX engine is one controller over an
``(R, T)`` mesh of devices (``shard_map``); here too, one process drives every shard, and a
mesh is an ``(R, T)`` grid of ``torch.device``s. Shard state lives in per-shard lists
``shards[r][t]``, each tensor on its mesh device, and each per-device body of the JAX engine
becomes a function run once a shard.

``make_mesh(shape)`` needs ``R·T`` devices, as JAX's does: on CUDA the visible cards
(``cuda:0`` … ``cuda:{n-1}``), so ``--mesh 2x2`` on a one-card host fails with JAX's message.
The one way around it is an explicit ``devices`` list, which may repeat a device:
``make_mesh((2, 4), [torch.device("cuda", 0)] * 8)`` runs the whole sharded program (route,
reads-axis finalize, sharded call) on one card. On the CPU (``device="cpu"``) the mesh is
``R·T`` copies of ``cpu``, the counterpart of JAX's forced host devices
(``--xla_force_host_platform_device_count``).

In one process every device is in one locality domain, so the table axis is always local
(``table_axis_ici_local`` is true); the check stays for the multi-process slice.

The collectives are what ``shard_map`` gives JAX: plain functions over per-shard lists, each
a ``.to(device, non_blocking=True)`` plus ``torch.cat`` / ``stack`` (no
``torch.distributed``). On one device the moves are no-ops; across cards they are peer
copies.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_READS = "reads"
AXIS_TABLE = "table"


class Mesh:
    """An ``(R, T)`` grid of devices over the axes (``reads``, ``table``)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"expected a (reads, table) grid of devices, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {AXIS_READS: self.devices.shape[0], AXIS_TABLE: self.devices.shape[1]}

    def device(self, r: int, t: int) -> torch.device:
        return self.devices[r, t]


def default_devices(device=None) -> List[torch.device]:
    """The devices a mesh draws from: every visible card, or (``device="cpu"``) one CPU
    device that ``make_mesh`` repeats."""
    from denovo_kmer_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(shape: Tuple[int, int], devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """Mesh over (reads=R, table=T) from ``devices`` (default ``default_devices(device)``:
    the cards, or ``R·T`` copies of ``cpu``). R·T must not exceed the devices given."""
    r, t = shape
    if devices is None:
        devices = default_devices(device)
        if devices[0].type == "cpu":
            devices = devices * (r * t)
    devs = [torch.device(d) for d in devices]
    if r * t > len(devs):
        raise ValueError(f"mesh {shape} needs {r*t} devices, have {len(devs)}")
    grid = np.empty((r, t), dtype=object)
    for i in range(r):
        for j in range(t):
            grid[i, j] = devs[i * t + j]
    return Mesh(grid)


def table_axis_ici_local(mesh: Mesh) -> bool:
    """True iff every table-axis group (one mesh row) lives inside one locality domain. One
    process is one domain, so every mesh the port builds is local."""
    return True


def assert_table_axis_ici_local(mesh: Mesh) -> None:
    """Raise when a table-axis group spans locality domains (never, in one process)."""
    if not table_axis_ici_local(mesh):
        raise RuntimeError("table axis spans locality domains")


# ---------------------------------------------------------------------------------------
# collectives over per-shard lists shards[r][t]
# ---------------------------------------------------------------------------------------

def all_to_all(mesh: Mesh, shards) -> list:
    """The tiled all_to_all over the table axis (JAX ``split_axis=0, concat_axis=0,
    tiled=True``): every ``shards[r][s]`` holds T blocks along dim 0; shard (r, t) receives
    block t of every (r, s), concatenated in order of s. It stays inside each reads row."""
    R, T = mesh.devices.shape
    out = []
    for r in range(R):
        blocks = [x.chunk(T, dim=0) if x.shape[0] else [x] * T for x in shards[r]]
        out.append([
            torch.cat([blocks[s][t].to(mesh.device(r, t), non_blocking=True)
                       for s in range(T)])
            for t in range(T)])
    return out


def psum(mesh: Mesh, shards, axes=(AXIS_READS, AXIS_TABLE)) -> list:
    """Sum over one or both mesh axes; every shard gets its group's total on its device."""
    R, T = mesh.devices.shape
    out = [[None] * T for _ in range(R)]
    for r in range(R):
        for t in range(T):
            rows = range(R) if AXIS_READS in axes else (r,)
            cols = range(T) if AXIS_TABLE in axes else (t,)
            dev = mesh.device(r, t)
            total = None
            for i in rows:
                for j in cols:
                    x = shards[i][j].to(dev, non_blocking=True)
                    total = x if total is None else total + x
            out[r][t] = total
    return out


def all_gather(mesh: Mesh, shards) -> list:
    """Gather over the reads axis: shard (r, t) gets ``stack([shards[0][t], …,
    shards[R-1][t]])`` on its device."""
    R, T = mesh.devices.shape
    return [[torch.stack([shards[i][t].to(mesh.device(r, t), non_blocking=True)
                          for i in range(R)])
             for t in range(T)] for r in range(R)]
