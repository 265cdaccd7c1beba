"""Device mesh (reads × table) and the collectives the sharded engine runs over it.

Port of ``denovo_kmer_tpu/parallel/mesh.py``. The JAX engine is one controller over an
``(R, T)`` mesh of devices (``shard_map``), and with ``jax.distributed`` one controller a
process, each driving its own devices. Here too: a mesh is an ``(R, T)`` grid of
``torch.device``s, shard state lives in per-shard lists ``shards[r][t]``, each tensor on its
mesh device, and each per-device body of the JAX engine becomes a function run once a shard
-- by the process that owns the shard (``Mesh.ranks``); the other cells hold ``None``.

One process: ``make_mesh(shape)`` needs ``R·T`` devices, as JAX's does: on CUDA the visible
cards (``cuda:0`` … ``cuda:{n-1}``), so ``--mesh 2x2`` on a one-card host fails with JAX's
message. An explicit ``devices`` list may repeat a device: ``make_mesh((2, 4),
[torch.device("cuda", 0)] * 8)`` runs the whole sharded program on one card. On the CPU
(``device="cpu"``) the mesh is ``R·T`` copies of ``cpu``, the counterpart of JAX's forced
host devices.

Several processes (``torch.distributed`` initialised, world size > 1; see
``parallel/distributed.initialize_distributed``): ``make_mesh`` gathers every rank's LOCAL
device list (default: the visible cards, or on the CPU ``R·T / world`` copies of ``cpu``; a
caller may pass its own, which may repeat ``cuda:0``) and places the cells as JAX places
devices: a locality domain is the owning rank, and each table-axis row stays inside one rank
whenever the shape allows. Otherwise it warns once with JAX's message and takes flat
(rank-major) order; ``table_axis_ici_local`` then reports the span.

The collectives are what ``shard_map`` gives JAX: functions over per-shard lists. Inside a
rank each is a ``.to(device, non_blocking=True)`` plus ``torch.cat`` / ``stack`` (no-ops on
one device, peer copies across cards). Across ranks the blocks a rank needs from others
travel in one ``torch.distributed.all_to_all_single`` of bytes a collective (``_fetch``),
on the backend the process group was initialised with: gloo gets host tensors (staged with
``.cpu()`` before and ``.to(device)`` after), NCCL device tensors. Results, and the shard
each block lands on, equal the single-process collectives.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.utils.device import resolve_device

AXIS_READS = "reads"
AXIS_TABLE = "table"


class Mesh:
    """An ``(R, T)`` grid of devices over the axes (``reads``, ``table``). ``ranks[r, t]``
    is the process that owns cell (r, t) (all 0 in one process), ``rank`` this process's,
    ``backend`` the process group's (None in one process)."""

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None,
                 rank: int = 0, world: int = 1, backend: Optional[str] = None):
        if devices.ndim != 2:
            raise ValueError(f"expected a (reads, table) grid of devices, got {devices.shape}")
        self.devices = devices
        self.ranks = np.zeros(devices.shape, np.int64) if ranks is None else ranks
        self.rank, self.world, self.backend = rank, world, backend

    @property
    def shape(self) -> dict:
        return {AXIS_READS: self.devices.shape[0], AXIS_TABLE: self.devices.shape[1]}

    def device(self, r: int, t: int) -> torch.device:
        return self.devices[r, t]

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    def is_local(self, r: int, t: int) -> bool:
        return int(self.ranks[r, t]) == self.rank

    def local_cells(self) -> List[Tuple[int, int]]:
        """This process's cells in ``r·T + t`` order."""
        R, T = self.devices.shape
        return [(r, t) for r in range(R) for t in range(T) if self.is_local(r, t)]

    @property
    def staging_device(self) -> torch.device:
        """Where cross-rank bytes travel from: the host for gloo, the card for NCCL."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


def _process_group():
    """(world size, rank, backend) of the initialised process group, or (1, 0, None)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def default_devices(device=None) -> List[torch.device]:
    """The devices a mesh draws from: every visible card, or (``device="cpu"``) one CPU
    device that ``make_mesh`` repeats."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def place(shape: Tuple[int, int], domains: Sequence) -> Tuple[np.ndarray, Optional[str]]:
    """JAX's placement over a device list whose i-th device lies in locality domain
    ``domains[i]``: an (R, T) grid of list indices whose table-axis rows each stay inside
    one domain, filled domain by domain, whenever the shape allows; else flat order and the
    warning text (None when there is one domain: nothing crosses a slow link)."""
    r, t = shape
    groups: "OrderedDict[object, list]" = OrderedDict()
    for i, d in enumerate(domains):
        groups.setdefault(d, []).append(i)
    rows = []
    for g in groups.values():
        for i in range(0, len(g) - t + 1, t):
            rows.append(g[i:i + t])
            if len(rows) == r:
                break
        if len(rows) == r:
            break
    if len(rows) == r:
        return np.array(rows, dtype=np.int64).reshape(r, t), None
    msg = None
    if len(groups) > 1:
        big = max(len(g) for g in groups.values())
        msg = (f"mesh {shape}: table axis (T={t}) cannot fit inside one locality "
               f"domain (domain sizes: {[len(g) for g in groups.values()]}); the "
               "route all_to_all will cross the slow inter-host link — prefer a "
               f"taller reads axis (e.g. {(r * t) // min(t, big)}x{min(t, big)}) "
               "or per-host table shards")
    return np.arange(r * t, dtype=np.int64).reshape(r, t), msg


def make_mesh(shape: Tuple[int, int], devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """Mesh over (reads=R, table=T). In one process from ``devices`` (default
    ``default_devices(device)``: the cards, or ``R·T`` copies of ``cpu``); R·T must not
    exceed the devices given. In a process group ``devices`` is this rank's local list and
    the cells are placed over every rank's (see the module docstring); every rank must own
    the same number of cells."""
    r, t = shape
    world, rank, backend = _process_group()
    if devices is None:
        devices = default_devices(device)
        if devices[0].type == "cpu":
            devices = devices * -(-(r * t) // world)
    names = [str(torch.device(d)) for d in devices]
    if world == 1:
        names = [names]
    else:
        import torch.distributed as dist

        gathered: list = [None] * world
        dist.all_gather_object(gathered, names)
        names = gathered
    flat = [(q, name) for q in range(world) for name in names[q]]
    if r * t > len(flat):
        raise ValueError(f"mesh {shape} needs {r*t} devices, have {len(flat)}")
    idx, msg = place(shape, [q for q, _ in flat])
    if msg is not None:
        warnings.warn(msg, stacklevel=2)
    grid = np.empty((r, t), dtype=object)
    ranks = np.empty((r, t), dtype=np.int64)
    for i in range(r):
        for j in range(t):
            q, name = flat[idx[i, j]]
            grid[i, j], ranks[i, j] = torch.device(name), q
    per_rank = np.bincount(ranks.reshape(-1), minlength=world)
    if (per_rank != per_rank[0]).any():
        raise ValueError(f"mesh {shape}: the ranks own {per_rank.tolist()} cells; every "
                         "process must own the same number (give each as many devices)")
    return Mesh(grid, ranks, rank, world, backend)


def table_axis_ici_local(mesh: Mesh) -> bool:
    """True iff every table-axis group (one mesh row) lives inside one locality domain (one
    process): the per-window route all_to_all never crosses the slow link."""
    return all(len(set(row.tolist())) == 1 for row in mesh.ranks)


def assert_table_axis_ici_local(mesh: Mesh) -> None:
    """Raise when a table-axis group spans locality domains. Multi-process entry points
    call this when the caller demands the local guarantee."""
    if not table_axis_ici_local(mesh):
        detail = [sorted({str(("process", int(q))) for q in row}) for row in mesh.ranks]
        raise RuntimeError(
            "table axis spans locality domains (route all_to_all would cross "
            f"the inter-host link); per-row domains: {detail}. Reshape the mesh "
            "so T fits inside one host/slice's devices."
        )


# ---------------------------------------------------------------------------------------
# across ranks: one all_to_all_single of bytes a collective, and host-value reductions
# ---------------------------------------------------------------------------------------

def _fetch(mesh: Mesh, wants, value, template) -> dict:
    """The cross-rank half of a collective. ``wants(q)``: the ordered ``(cell, tag)`` list
    rank q reads from cells it does not own (the same on every rank); ``value(cell, tag)``:
    the local tensor; ``template(tag)``: a local tensor of that tag's shape and dtype (every
    shard's is the same). → ``{(cell, tag): tensor}`` of this rank's wants, on the staging
    device. Every rank must call it, in the same order."""
    import torch.distributed as dist

    me, stage = mesh.rank, mesh.staging_device
    lists = [wants(q) for q in range(mesh.world)]
    if not any(lists):
        return {}
    send, send_sizes = [], []
    for q in range(mesh.world):
        part = [] if q == me else [value(c, tag).reshape(-1).contiguous().to(stage)
                                   .view(torch.uint8)
                                   for c, tag in lists[q] if mesh.ranks[c] == me]
        send.extend(part)
        send_sizes.append(sum(b.numel() for b in part))
    specs, recv_sizes = [], []
    for p in range(mesh.world):
        mine = [] if p == me else [(c, tag) for c, tag in lists[me] if mesh.ranks[c] == p]
        for c, tag in mine:
            x = template(tag)
            specs.append((c, tag, x.shape, x.dtype, x.numel() * x.element_size()))
        recv_sizes.append(sum(s[4] for s in specs[len(specs) - len(mine):]))
    inp = torch.cat(send) if send else torch.empty(0, dtype=torch.uint8, device=stage)
    out = torch.empty(sum(recv_sizes), dtype=torch.uint8, device=stage)
    dist.all_to_all_single(out, inp, recv_sizes, send_sizes)
    got, off = {}, 0
    for c, tag, shp, dtype, nb in specs:
        got[(c, tag)] = out[off:off + nb].clone().view(dtype).reshape(shp)
        off += nb
    return got


def reduce_host(mesh: Mesh, value: int, op: str) -> int:
    """A host integer reduced over the ranks (``op`` "max" or "sum"); itself in one
    process."""
    if not mesh.spans_processes:
        return int(value)
    import torch.distributed as dist

    x = torch.tensor([int(value)], dtype=torch.int64, device=mesh.staging_device)
    dist.all_reduce(x, op={"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op])
    return int(x.item())


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` in one process)."""
    if not mesh.spans_processes:
        return [obj]
    import torch.distributed as dist

    out: list = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def gather_cells(mesh: Mesh, shards, cells) -> dict:
    """``{cell: tensor}`` for every listed cell on every rank: the local ones as they are,
    the others fetched (on the staging device)."""
    got = {c: shards[c[0]][c[1]] for c in cells if mesh.is_local(*c)}
    if mesh.spans_processes:
        r0, t0 = mesh.local_cells()[0]
        remote = _fetch(mesh,
                        lambda q: [(c, None) for c in cells if int(mesh.ranks[c]) != q],
                        lambda c, _tag: shards[c[0]][c[1]],
                        lambda _tag: shards[r0][t0])
        got.update({c: x for (c, _tag), x in remote.items()})
    return got


# ---------------------------------------------------------------------------------------
# collectives over per-shard lists shards[r][t] (None where another rank owns the cell)
# ---------------------------------------------------------------------------------------

def _unique(items) -> list:
    return list(OrderedDict.fromkeys(items))


def all_to_all(mesh: Mesh, shards) -> list:
    """The tiled all_to_all over the table axis (JAX ``split_axis=0, concat_axis=0,
    tiled=True``): every ``shards[r][s]`` holds T blocks along dim 0; shard (r, t) receives
    block t of every (r, s), concatenated in order of s. It stays inside each reads row."""
    R, T = mesh.devices.shape
    blocks = {(r, s): (shards[r][s].chunk(T, dim=0) if shards[r][s].shape[0]
                       else [shards[r][s]] * T)
              for r, s in mesh.local_cells()}
    remote = {}
    if mesh.spans_processes:
        first = blocks[mesh.local_cells()[0]]
        remote = _fetch(
            mesh,
            lambda q: [((r, s), t) for r in range(R) for t in range(T)
                       if mesh.ranks[r, t] == q for s in range(T) if mesh.ranks[r, s] != q],
            lambda c, t: blocks[c][t], lambda t: first[t])
    return [[torch.cat([(blocks[(r, s)][t] if (r, s) in blocks else remote[((r, s), t)])
                        .to(mesh.device(r, t), non_blocking=True) for s in range(T)])
             if mesh.is_local(r, t) else None
             for t in range(T)] for r in range(R)]


def psum(mesh: Mesh, shards, axes=(AXIS_READS, AXIS_TABLE)) -> list:
    """Sum over one or both mesh axes; every shard gets its group's total on its device."""
    R, T = mesh.devices.shape

    def group(r, t):
        rows = range(R) if AXIS_READS in axes else (r,)
        cols = range(T) if AXIS_TABLE in axes else (t,)
        return [(i, j) for i in rows for j in cols]

    remote = {}
    if mesh.spans_processes:
        r0, t0 = mesh.local_cells()[0]
        remote = _fetch(
            mesh,
            lambda q: _unique((c, None) for r in range(R) for t in range(T)
                              if mesh.ranks[r, t] == q for c in group(r, t)
                              if mesh.ranks[c] != q),
            lambda c, _tag: shards[c[0]][c[1]], lambda _tag: shards[r0][t0])
    out = [[None] * T for _ in range(R)]
    for r, t in mesh.local_cells():
        dev = mesh.device(r, t)
        total = None
        for i, j in group(r, t):
            x = shards[i][j] if mesh.is_local(i, j) else remote[((i, j), None)]
            x = x.to(dev, non_blocking=True)
            total = x if total is None else total + x
        out[r][t] = total
    return out


def all_gather(mesh: Mesh, shards) -> list:
    """Gather over the reads axis: shard (r, t) gets ``stack([shards[0][t], …,
    shards[R-1][t]])`` on its device."""
    R, T = mesh.devices.shape
    remote = {}
    if mesh.spans_processes:
        r0, t0 = mesh.local_cells()[0]
        remote = _fetch(
            mesh,
            lambda q: _unique(((i, t), None) for r in range(R) for t in range(T)
                              if mesh.ranks[r, t] == q for i in range(R)
                              if mesh.ranks[i, t] != q),
            lambda c, _tag: shards[c[0]][c[1]], lambda _tag: shards[r0][t0])
    return [[torch.stack([(shards[i][t] if mesh.is_local(i, t) else remote[((i, t), None)])
                          .to(mesh.device(r, t), non_blocking=True) for i in range(R)])
             if mesh.is_local(r, t) else None
             for t in range(T)] for r in range(R)]
