"""Single-decode multipass: partition-spill of extracted k-mers.

Port of ``denovo_kmer_tpu/ops/spill.py``. The re-decode multipass
(``pipeline.run_trio_multipass``) decodes and extracts every stream once per pass; this
decodes and extracts once:

  1. one extract pass: reads → staging window (no pass filter);
  2. on window-full, one partition (``partition_window``) splits the window into per-pass
     compacted row blocks;
  3. the blocks go to a per-pass spill: a device ``PassStore`` or host files (``HostSpill``);
  4. each counting pass folds only its own rows.

``partition_window`` on CUDA tensors runs the hand-written partition kernel
(``ops/partition.py:partition_spill_blocks``) over the window and assembles the per-pass
blocks with plain torch; on CPU tensors it calls the plain ``router.bucketize``. Both give
``bucketize``'s rows in ``bucketize``'s order: a stable per-block partition whose blocks are
concatenated bucket by bucket is one stable sort by bucket.

Exactness: the partition counts overflow instead of dropping (``SpillOverflowError`` names
the fix), and the pass partition is a partition of the key space, so per-pass candidates
union to exactly the single-pass result.

Spans and tallies (``utils/metrics.py``): ``spill.partition`` around a window's partition,
``spill.store`` around ``store_append`` (its read of the window's counts waits for the
partition, so a profile shows there how long the host blocks on each window) and
``spill.fold`` around a pass's fold from either spill (``_fold_pass``: device spans; the table
steps' own spans sit inside it); ``rows_partitioned`` tallies the staged rows a partition
reads, ``rows_spilled`` the rows appended to a store or a host spill.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.ops.partition import partition_spill_blocks
from denovo_kmer_tpu_torch.ops.score import flush_score
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, flush, staged_valid
from denovo_kmer_tpu_torch.ops.table import KmerTable
from denovo_kmer_tpu_torch.parallel.router import bucketize, pass_of, route_capacity
from denovo_kmer_tpu_torch.utils.device import resolve_device
from denovo_kmer_tpu_torch.utils.metrics import span, tally

#: rows per block of the partition kernel (one CTA each)
SPILL_BLOCK_LANES = 32768


class SpillOverflowError(RuntimeError):
    """A partition window overflowed its per-pass capacity, or a pass overflowed the device
    store — retry with a larger ``capacity_factor`` or ``device_store_rows``."""


class PassStore(NamedTuple):
    """Device spill: per-pass compacted k-mer rows.

    ``rows`` is allocated with one window-capacity of slack beyond the logical per-pass
    budget (``alloc_pass_rows``), as in the JAX package. A torch slice write does not clamp
    the way XLA's ``dynamic_update_slice`` does; ``store_append`` writes only the rows that
    fit and still advances ``fill`` by every row, so the callers' post-stream guard
    (``fill > budget``) raises before anything is read back."""

    rows: torch.Tensor  # (P, N, W) int32 — uint32 key words, bit for bit
    fill: Tuple[int, ...]  # rows appended per pass (host ints; may exceed N on overflow)


def alloc_pass_rows(rows_per_pass: int, window_cap: int, chunk_rows: int) -> int:
    """Allocation size for one pass's store rows: the logical budget plus one
    window-capacity of slack, kept a multiple of ``chunk_rows``."""
    return rows_per_pass + -(-window_cap // chunk_rows) * chunk_rows


def empty_pass_store(n_passes: int, rows_per_pass: int, words: int,
                     device=None) -> PassStore:
    """An empty store on ``device`` (``None``: the card). ``rows_per_pass`` here is the
    ALLOCATED size (``alloc_pass_rows``)."""
    device = resolve_device(device)
    return PassStore(
        rows=torch.zeros((n_passes, rows_per_pass, words), dtype=torch.int32, device=device),
        fill=(0,) * n_passes,
    )


def _window_ids(acc: KmerAccumulator, n_passes: int) -> torch.Tensor:
    """(S,) int32 pass bucket of each staged row; invalid rows and rows at or past ``fill``
    go to bucket ``n_passes``, as ``bucketize`` sends them to its virtual shard."""
    return torch.where(staged_valid(acc), pass_of(acc.kmers, n_passes),
                       n_passes).to(torch.int32)


def assemble_blocks(out: torch.Tensor, block_counts: torch.Tensor, n_passes: int,
                    capacity: int, block_lanes: int):
    """Per-pass blocks from a per-block partition: ``out`` (W, S), each ``block_lanes``
    slice bucket-major, and ``block_counts`` (G, n_passes + 1). Bucket p's rows are block
    0's bucket-p run, then block 1's, and so on; slot c of pass p is found by a search over
    the exclusive cumsum of the per-block counts, then gathered.

    Returns (disp (P, capacity, W), counts (P,) int32, overflow () int64); only
    ``disp[p, :counts[p]]`` is defined."""
    W, S = out.shape
    dev = out.device
    bc = block_counts.to(torch.int64)
    G = bc.shape[0]
    # start of each (block, bucket) run in ``out``
    run0 = (torch.arange(G, dtype=torch.int64, device=dev)[:, None] * block_lanes
            + torch.cumsum(bc, 1) - bc)[:, :n_passes]
    per = bc[:, :n_passes]
    incl = torch.cumsum(per, 0)  # (G, P): rows of the bucket in blocks 0..g
    total = incl[-1]
    slot = torch.arange(capacity, dtype=torch.int64, device=dev).expand(n_passes, capacity)
    g = torch.searchsorted(incl.T.contiguous(), slot.contiguous(), right=True)
    g = g.clamp(max=G - 1)
    src = run0.T.gather(1, g) + slot - (incl - per).T.gather(1, g)
    disp = out.T[src.clamp(0, S - 1)]
    counts = total.clamp(max=capacity)
    return disp, counts.to(torch.int32), (total - counts).sum()


def partition_window_blocks(acc: KmerAccumulator, n_passes: int, capacity: int):
    """The card's route of ``partition_window``: pass ids, the partition kernel over the
    ``(W, S)`` view of the staging rows (``n_passes + 1`` buckets, the last for dropped
    rows), then ``assemble_blocks``. On CPU tensors the partition is its plain version."""
    ids = _window_ids(acc, n_passes)
    out, bcounts = partition_spill_blocks(acc.kmers.T, ids, n_passes + 1, SPILL_BLOCK_LANES)
    return assemble_blocks(out, bcounts, n_passes, capacity, SPILL_BLOCK_LANES)


def partition_window(
    acc: KmerAccumulator, n_passes: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, KmerAccumulator]:
    """Partition a staging window into per-pass compacted blocks.

    Returns (disp (P, capacity, W), counts (P,) int32, overflow (), reset acc). Rows beyond
    ``counts[p]`` within a block are undefined — consumers honor counts. On CUDA tensors
    the partition kernel runs (``partition_window_blocks``); on CPU tensors the plain
    ``router.bucketize``, keyed by ``pass_of``."""
    tally("rows_partitioned", acc.fill)
    with span("spill.partition", acc.kmers.device):
        if acc.kmers.device.type == "cuda":
            disp, counts, ovf = partition_window_blocks(acc, n_passes, capacity)
        else:
            disp, mask, _src, ovf = bucketize(acc.kmers, staged_valid(acc), n_passes,
                                              capacity, owner=pass_of(acc.kmers, n_passes))
            counts = mask.sum(1).to(torch.int32)
    return disp, counts, ovf, acc._replace(fill=0)


def _spilled_counts(counts) -> List[int]:
    """A partitioned window's per-pass row counts on the host (the window's one sync),
    tallied as ``rows_spilled``."""
    counts = torch.as_tensor(counts).cpu().tolist()
    tally("rows_spilled", sum(counts))
    return counts


def store_append(store: PassStore, disp: torch.Tensor, counts) -> PassStore:
    """Append a partitioned window to the device store, in place: one slice write per
    pass at its fill. Rows past the allocation are not written, but ``fill`` advances by
    every row so the overflow guard sees them."""
    alloc = store.rows.shape[1]
    fill = list(store.fill)
    with span("spill.store", store.rows.device):
        for p, c in enumerate(_spilled_counts(counts)):
            take = max(0, min(c, alloc - fill[p]))
            if take:
                store.rows[p, fill[p]:fill[p] + take] = disp[p, :take]
            fill[p] += c
    return PassStore(rows=store.rows, fill=tuple(fill))


def spill_capacity(acc_slots: int, n_passes: int, factor: float) -> int:
    """Per-pass block capacity for one partitioned window (even split × factor)."""
    return route_capacity(acc_slots, n_passes, factor)


# ---------------------------------------------------------------------------
# counting from a spill: fold stored rows (no extraction) into tables
# ---------------------------------------------------------------------------

def _pass_chunks(spill, pass_id: int, chunk_rows: int,
                 device) -> Iterator[Tuple[torch.Tensor, int]]:
    """Pass ``pass_id`` of a ``PassStore`` or a ``HostSpill`` as (rows (chunk_rows, W) int32
    on ``device``, valid rows) chunks, at least one where the pass is empty: slices of the
    store's rows (a multiple of ``chunk_rows`` a pass), or the host files read a chunk at
    a time (``read_chunks``), each copied to the device."""
    if isinstance(spill, HostSpill):
        return ((torch.from_numpy(buf.view(np.int32)).to(device), take)
                for buf, take in spill.read_chunks(pass_id, chunk_rows))
    N = spill.rows.shape[1]
    if N % chunk_rows:
        raise ValueError(f"store rows/pass ({N}) % chunk_rows ({chunk_rows}) != 0")
    n, rows = spill.fill[pass_id], spill.rows[pass_id]
    return ((rows[start:start + chunk_rows], n - start)
            for start in range(0, max(n, 1), chunk_rows))


def _fold_pass(chunks, state, step):
    """Fold a pass's chunks into ``state`` (a KmerTable through ``flush``, a ScoreTable
    through ``flush_score``), one ``step`` a chunk, inside one ``spill.fold`` span."""
    dev = state.keys.device
    with span("spill.fold", dev):
        for rows, n_valid in chunks:
            S = rows.shape[0]
            acc = KmerAccumulator(kmers=rows, valid=torch.arange(S, device=dev) < n_valid,
                                  fill=S)
            state = step(acc, state)[1]
    return state


def count_pass_from_store(store, pass_id: int, table: KmerTable, chunk_rows: int) -> KmerTable:
    """Build or extend ``table`` from pass ``pass_id`` of a ``PassStore`` or a ``HostSpill``,
    ``chunk_rows`` at a time (one flush each)."""
    return _fold_pass(_pass_chunks(store, pass_id, chunk_rows, table.keys.device), table,
                      flush)


def score_pass_from_store(store, pass_id: int, stab, chunk_rows: int):
    """``count_pass_from_store`` into a parent-seeded ScoreTable (one ``flush_score`` a
    chunk): the child's pass."""
    return _fold_pass(_pass_chunks(store, pass_id, chunk_rows, stab.keys.device), stab,
                      flush_score)


# ---------------------------------------------------------------------------
# host spill: per-pass raw row files
# ---------------------------------------------------------------------------

def source_signature(path: str, cfg, region=None) -> dict:
    """Identity of a spill's INPUT: file path, size and mtime, plus every config knob
    outside ``config_hash`` that changes the extracted k-mer multiset (max_read_len
    truncation, length buckets) or the record set (region). Stored in the manifest so a
    resume never reuses a spill produced from different inputs."""
    st = os.stat(path)
    ref = getattr(cfg, "reference_fasta", None)
    ref_sig = None
    if ref:
        # reference-based CRAM decodes sequences against this file
        try:
            rst = os.stat(ref)
            ref_sig = {"path": os.path.abspath(ref), "size": rst.st_size,
                       "mtime_ns": rst.st_mtime_ns}
        except OSError:
            ref_sig = {"path": os.path.abspath(ref)}
    return {
        "path": os.path.abspath(path),
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "region": region if isinstance(region, (str, type(None))) else list(region),
        "max_read_len": cfg.max_read_len,
        "read_len_buckets": (list(cfg.read_len_buckets)
                             if cfg.read_len_buckets else None),
        "reference": ref_sig,
    }


class HostSpill:
    """Per-pass spill files of raw uint32 k-mer rows under ``directory``.

    Layout (the JAX package's, byte for byte): ``<dir>/<sample>.pass<p>.u32`` — a flat
    little-endian uint32 stream of W-word rows, append-only; ``<dir>/<sample>.manifest.json``
    marks a COMPLETE spill (config hash + source signature + per-pass row counts) and gates
    resume: a sample whose manifest exists and matches is never re-decoded. The manifest is
    written atomically (tmp + rename), and a truncated or corrupt one reads as "not
    complete", so an interrupted run never crashes its resume."""

    def __init__(self, directory: str, sample: str, n_passes: int, words: int,
                 config_hash: str, source_sig: Optional[dict] = None):
        self.dir = directory
        self.sample = sample
        self.n_passes = n_passes
        self.words = words
        self.config_hash = config_hash
        self.source_sig = source_sig
        os.makedirs(directory, exist_ok=True)
        self._files = None
        self.counts: List[int] = [0] * n_passes

    def path(self, p: int) -> str:
        return os.path.join(self.dir, f"{self.sample}.pass{p}.u32")

    def manifest_path(self) -> str:
        return os.path.join(self.dir, f"{self.sample}.manifest.json")

    def complete(self) -> bool:
        """True iff a matching manifest exists (spill finished; safe to reuse)."""
        mp = self.manifest_path()
        if not os.path.exists(mp):
            return False
        try:
            with open(mp) as f:
                m = json.load(f)
            counts = [int(c) for c in m["counts"]]
            if len(counts) != self.n_passes:
                return False
        except (OSError, ValueError, KeyError, TypeError):
            return False  # truncated/corrupt manifest -> re-spill, never crash
        if (m.get("config_hash") != self.config_hash
                or m.get("n_passes") != self.n_passes
                or m.get("words") != self.words
                or m.get("source_sig") != self.source_sig):
            return False
        self.counts = counts
        return all(
            os.path.exists(self.path(p))
            and os.path.getsize(self.path(p)) == self.counts[p] * self.words * 4
            for p in range(self.n_passes)
        )

    def open_for_write(self) -> None:
        self._files = [open(self.path(p), "wb") for p in range(self.n_passes)]
        self.counts = [0] * self.n_passes

    def append_window(self, disp: torch.Tensor, counts) -> None:
        """Write one partitioned window ((P, cap, W) int32 bits + per-pass counts): only
        ``disp[p, :counts[p]]`` leaves the device."""
        for p, c in enumerate(_spilled_counts(counts)):
            if c:
                rows = disp[p, :c].cpu().numpy()
                self._files[p].write(np.ascontiguousarray(rows).tobytes())
                self.counts[p] += c

    def finish(self) -> None:
        for f in self._files:
            f.close()
        self._files = None
        mp = self.manifest_path()
        tmp = mp + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "config_hash": self.config_hash,
                "n_passes": self.n_passes,
                "words": self.words,
                "source_sig": self.source_sig,
                "counts": self.counts,
            }, f)
        os.replace(tmp, mp)  # atomic: a kill mid-write cannot leave a half manifest

    def abort(self) -> None:
        if self._files:
            for f in self._files:
                f.close()
            self._files = None

    def read_chunks(self, p: int, chunk_rows: int) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (rows (chunk_rows, W) np.uint32, n_valid) chunks of pass ``p`` (the last
        chunk zero-padded)."""
        n = self.counts[p]
        with open(self.path(p), "rb") as f:
            done = 0
            while done < n:
                take = min(chunk_rows, n - done)
                buf = np.fromfile(f, dtype=np.uint32, count=take * self.words)
                buf = buf.reshape(take, self.words)
                if take < chunk_rows:
                    pad = np.zeros((chunk_rows, self.words), np.uint32)
                    pad[:take] = buf
                    buf = pad
                yield buf, take
                done += take
        if n == 0:
            yield np.zeros((chunk_rows, self.words), np.uint32), 0
