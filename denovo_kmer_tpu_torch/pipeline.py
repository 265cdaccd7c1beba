"""End-to-end trio pipeline: BAM/FASTQ streams → parental tables → child scoring → report.

Port of the single-device paths of ``denovo_kmer_tpu/pipeline.py``. ``run_trio``: the host
feeder decodes and 2-bit-packs read batches, the extraction kernel appends each batch's
canonical k-mers to a staging buffer on the device, LSM flushes fold the staging buffer into
sorted count tables, the child is scored against a parent-seeded table and the final window
runs the fused one-sort call; only the candidate set crosses back to the host for the TSV.
``run_trio_multipass`` runs that once per hash pass with the pass filter in the extraction
kernel; ``run_trio_spill`` decodes once, partitions each staging window by pass with the
partition kernel into a device store or host files, and counts each pass from its spill.
Every trio path takes ``count`` checkpoints (``.npz``) as parents where the JAX package does,
and length buckets (``cfg.read_len_buckets``: each read packed, and extracted, at the
smallest bucket width that holds it). ``build_sample_table_resumable`` persists the running
table with the BAM virtual-offset cursor so that a killed ``count`` resumes where it stopped.
Plain local BAMs are decoded by the C++ feeder (``io/native.py``) when it builds, else in
Python; local CRAMs by the columnar feeder (``io/cram.py`` → ``ops/pack.pack_chunks``); region,
SAM, FASTQ/FASTA and remote (``http(s)://``, ``s3://``, ``gs://``) sources by the Python record
loop. The batches are the same whichever feeder makes them.

Entry points run on the card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.io.fasta import read_fasta, read_fastq
from denovo_kmer_tpu_torch.io.prefetch import close_unless_leaked, prefetch_placed
from denovo_kmer_tpu_torch.ops.extract import extract_append as _extract_append
from denovo_kmer_tpu_torch.ops.fused import fused_call_full, fused_supported
from denovo_kmer_tpu_torch.ops.pack import PackedReads, pack_records, pack_records_bucketed
from denovo_kmer_tpu_torch.ops.partition import MAX_SPILL_BUCKETS
from denovo_kmer_tpu_torch.ops.score import (
    ScoreTable,
    call_from_score,
    flush_score,
    seed_score_table,
)
from denovo_kmer_tpu_torch.ops.stream import empty_accumulator, flush
from denovo_kmer_tpu_torch.ops.table import (
    KmerTable,
    empty_table,
    table_from_numpy,
    table_to_numpy,
)
from denovo_kmer_tpu_torch.ops.trio import Candidates
from denovo_kmer_tpu_torch.oracle.scalar import words_to_kmer_value
from denovo_kmer_tpu_torch.parallel.router import pass_of
from denovo_kmer_tpu_torch.utils.checkpoint import maybe_load_flat_table
from denovo_kmer_tpu_torch.utils.metrics import Metrics

_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

class TableOverflowError(RuntimeError):
    """Unique k-mers exceeded table capacity — rerun with a larger --table-capacity."""


def _overflow_msg(n: int, capacity: int, what: str = "unique k-mers") -> str:
    """Actionable overflow message: suggest a concrete capacity.

    ``n`` is the true unique count when THIS aggregation overflowed, but only a lower bound
    (capacity+1) when a sticky flag from an earlier flush carried through — the suggestion
    covers both: headroom over max(n, capacity), next power of two.
    """
    floor = max(n, capacity)
    suggest = 1 << (int(floor * 1.3) - 1).bit_length()
    exact = n > capacity + 1
    bound = f"{n}" if exact else f"more than {capacity}"
    return f"{bound} {what} exceed table capacity {capacity}; rerun with --table-capacity {suggest}"


def _report_feed_stats(m: Metrics, stats: dict) -> None:
    """Feeder telemetry: consumer starvation = the dispatch thread waited on the
    feed/transfer pipeline (feeder-bound); producer wait = the transfer thread waited on a
    full queue (device-bound). Emitted as a metrics event; a starved run warns on stderr."""
    if not stats or not stats.get("items"):
        return
    wall = stats.get("wall_s", 0.0)
    cw = stats.get("consumer_wait_s", 0.0)
    starved = wall > 0.5 and cw > 0.6 * wall
    m.add_seconds("feed_wait", cw)
    m.event(
        "feed_pipeline",
        batches=stats["items"],
        wall_s=round(wall, 3),
        consumer_wait_s=round(cw, 3),
        producer_wait_s=round(stats.get("producer_wait_s", 0.0), 3),
        feeder_bound=bool(starved),
    )
    if starved:
        print(
            f"WARNING: the feed pipeline starved the device {cw:.1f}s of {wall:.1f}s "
            f"({cw / wall:.0%}) — the host feeder is the bottleneck",
            file=sys.stderr,
        )


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: the port never carries
    on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class TrioResult:
    candidates: List[Tuple[int, int, int, int]]  # (kmer_value, child, mom, dad)
    report: str
    metrics: Metrics
    tables_n: Dict[str, int]


@dataclasses.dataclass
class _FakeRec:
    seq: str
    qual: Optional[Sequence[int]]
    flag: int
    name: Optional[str] = None


def _record_stream(path: str, cfg: EngineConfig, region: Optional[str] = None) -> Iterator:
    """Open a reads file as a record stream (BAM/CRAM/SAM/FASTQ/FASTA by extension; a local
    path or a URL).

    ``region`` (``chr20`` / ``chr20:1,000-2,000``): BAM (BAI/CSI) or CRAM (CRAI) —
    served through the index when one sits next to the file, full-scan overlap
    filter otherwise (SAM text has no index format; pre-convert for region queries).
    A list of regions (``--regions-bed``) takes BAM only.
    """
    low = path.lower()
    if region and not low.endswith((".bam", ".cram")):
        raise ValueError(f"--region requires a BAM or CRAM input, got {path}")
    if isinstance(region, (list, tuple)):
        # --regions-bed: multi-region restriction (samtools view -M -L semantics)
        if not low.endswith(".bam"):
            raise ValueError(
                f"--regions-bed requires BAM inputs (CRAM supports a single "
                f"--region), got {path}")
        from denovo_kmer_tpu_torch.io.bai import read_bam_records_regions

        return read_bam_records_regions(path, list(region))
    if low.endswith(".bam"):
        if region:
            from denovo_kmer_tpu_torch.io.bai import read_bam_records_region

            return read_bam_records_region(path, region)
        return read_bam_records(path)
    if low.endswith(".cram") and region:
        from denovo_kmer_tpu_torch.io.crai import read_cram_records_region
        from denovo_kmer_tpu_torch.io.fasta import load_reference_indexed

        ref = (load_reference_indexed(cfg.reference_fasta)
               if cfg.reference_fasta else None)
        return read_cram_records_region(path, region, reference=ref)
    if low.endswith((".sam", ".sam.gz")):
        from denovo_kmer_tpu_torch.io.sam import read_sam_records

        return read_sam_records(path)
    if low.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
        def gen():
            for name, seq, qual in read_fastq(path):
                yield _FakeRec(seq, qual, 0, name)
        return gen()
    if low.endswith((".fasta", ".fa", ".fasta.gz", ".fa.gz")):
        def gen():
            for name, seq in read_fasta(path):
                yield _FakeRec(seq, None, 0, name)
        return gen()
    if low.endswith(".cram"):
        from denovo_kmer_tpu_torch.io.cram import read_cram_records

        return read_cram_records(path, reference=cfg.reference_fasta)
    raise ValueError(f"unrecognized reads file extension: {path}")


def make_ingest_step(cfg: EngineConfig, n_passes: int = 1):
    """The per-batch ingest step of a config: ``append_packed(acc, packed, pass_id=0)``
    extracts a placed batch straight into the staging buffer — length-shipped
    (``vwords is None``) or with its validity words. ``n_passes > 1``: only k-mers whose
    ``router.pass_of`` bucket is ``pass_id`` stay valid (the multipass filter, fused into
    the extraction kernel). The JAX package's ``extractor`` field picks a TPU layout; here
    every value runs the same CUDA kernel. The step extracts at ``cfg.max_read_len``
    (``make_bucketed_extract_steps`` gives one step a bucket width)."""

    def append_packed(acc, packed: PackedReads, pass_id: int = 0):
        lengths = packed.length if packed.vwords is None else None
        return _extract_append(acc, packed.words, packed.vwords, lengths,
                               cfg.k, cfg.max_read_len, cfg.canonical, n_passes, pass_id)

    return append_packed


def make_bucketed_extract_steps(cfg: EngineConfig, n_passes: int = 1):
    """One ingest step a bucket width (cfg.read_len_buckets), all appending into the SAME
    staging buffer: k-mer rows do not depend on the width, so bucketing only changes how
    many windows each batch stages. The extraction kernel runs at each width's
    ``max_read_len``."""
    buckets = tuple(cfg.read_len_buckets or (cfg.max_read_len,))
    return {
        w: make_ingest_step(
            dataclasses.replace(cfg, max_read_len=w, read_len_buckets=None), n_passes)
        for w in buckets
    }


def _pass_steps(steps, pass_id: int):
    """The multipass filter of pass ``pass_id`` bound into each of ``steps`` (a dict of
    bucket steps, or one step)."""
    if isinstance(steps, dict):
        return {w: _pass_steps(s, pass_id) for w, s in steps.items()}
    return lambda acc, packed, _s=steps: _s(acc, packed, pass_id)


def _staging_slots(cfg: EngineConfig) -> int:
    return cfg.accum_batches * cfg.batch_reads * cfg.windows_per_read


def _bucketed_stream(source, cfg: EngineConfig, region: Optional[str] = None):
    """(bucket_width, PackedReads) pairs of a reads-file path or a record iterable, packed
    in Python as the JAX package's bucketed paths do."""
    if isinstance(source, str):
        source = _record_stream(source, cfg, region)
    return pack_records_bucketed(source, cfg)


@dataclasses.dataclass
class FoldLane:
    """One staging buffer of the fold loop: a config's ingest steps by bucket width
    (``steps[width](acc, packed) -> acc`` appends a batch's windows to ``acc``), the staging
    buffer, the state it folds into, and ``flush_fn(acc, state) -> (acc, state)``.
    ``final_flush`` folds what is staged when the stream ends (False leaves the last window
    for the fused call). A multi-k sweep runs one lane a k over one stream."""

    cfg: EngineConfig
    steps: dict
    acc: object
    state: object
    flush_fn: Callable
    final_flush: bool = True
    fill: int = 0


def _fold_stream(items: Iterable, lanes: Sequence[FoldLane], m: Metrics,
                 timer: str = "extract_probe", after_flush=None) -> None:
    """The LSM fold loop of every streaming build. ``items`` are placed (bucket_width,
    PackedReads) pairs; an unbucketed stream is the one-width case (``cfg.max_read_len``).
    Every batch feeds every lane: a lane flushes when the batch would not fit in its staging
    buffer (flushes follow staged windows, since a batch stages width-proportional rows).
    ``after_flush(state)`` runs after each flush inside the stream, before the next batch is
    extracted. Lanes are updated in place. ``reads_ingested`` and ``batches`` count once a
    batch, ``kmers_extracted`` and ``windows_staged`` once a lane."""
    for lane in lanes:
        lane.fill = 0
    for w, packed in items:
        m.count("reads_ingested", packed.n_reads)
        m.count("batches", 1)
        for lane in lanes:
            cfg = lane.cfg
            per_read = max(w - cfg.k + 1, 0)
            win = cfg.batch_reads * per_read
            if lane.fill + win > _staging_slots(cfg):
                with m.timer(timer):
                    lane.acc, lane.state = lane.flush_fn(lane.acc, lane.state)
                lane.fill = 0
                if after_flush is not None:
                    after_flush(lane.state)
            with m.timer(timer):
                lane.acc = lane.steps[w](lane.acc, packed)
            lane.fill += win
            m.count("kmers_extracted", packed.n_reads * per_read)
            m.count("windows_staged", win)
    for lane in lanes:
        if lane.fill and lane.final_flush:
            with m.timer(timer):
                lane.acc, lane.state = lane.flush_fn(lane.acc, lane.state)


def _placed_items(batches: Iterable, cfg: EngineConfig, device: torch.device,
                  bucketed: bool, stats: Optional[dict] = None):
    """Place a batch stream on ``device`` (prefetched) as ``_fold_stream``'s items: a
    bucketed stream as it is, an unbucketed one as the one-width case. → (feed, items);
    closing ``feed`` stops the prefetch threads."""
    feed = prefetch_placed(batches, device, ship_lengths=True, stats=stats)
    if bucketed:
        return feed, feed
    return feed, ((cfg.max_read_len, p) for p in feed)


def _fold_placed(batches: Iterable, cfg: EngineConfig, device: torch.device,
                 lanes: Sequence[FoldLane], m: Metrics, bucketed: bool = False) -> None:
    """Decode and place ``batches`` once and fold every batch into every lane; the feed's
    starvation goes to ``m`` (``feed_wait``)."""
    feed_stats: dict = {}
    _, items = _placed_items(batches, cfg, device, bucketed, feed_stats)
    _fold_stream(items, lanes, m)
    _report_feed_stats(m, feed_stats)


def _steps(cfg: EngineConfig, append_packed, bucket_steps) -> dict:
    """A lane's ingest steps by width: ``bucket_steps`` for a bucketed stream, else
    ``append_packed`` at ``cfg.max_read_len``."""
    return bucket_steps if bucket_steps is not None else {cfg.max_read_len: append_packed}


def _check_table(table: KmerTable, cfg: EngineConfig,
                 what: str = "unique k-mers") -> int:
    """Host check of a built table: → its ``n``; TableOverflowError above capacity."""
    n = int(table.n)
    if n > cfg.table_capacity:
        raise TableOverflowError(_overflow_msg(n, cfg.table_capacity, what))
    return n


class SampleTableBuilder:
    """Streams one sample's packed batches into its k-mer table."""

    def __init__(self, cfg: EngineConfig, device=None, append_packed=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.append_packed = append_packed or make_ingest_step(cfg)

    def lane(self, bucket_steps=None) -> FoldLane:
        """A fold lane that counts into an empty table."""
        cfg = self.cfg
        return FoldLane(cfg, _steps(cfg, self.append_packed, bucket_steps),
                        empty_accumulator(_staging_slots(cfg), cfg.words, self.device),
                        empty_table(cfg.table_capacity, cfg.words, self.device), flush)

    def build(self, packed_batches: Iterable, metrics: Optional[Metrics] = None,
              bucket_steps=None) -> KmerTable:
        """Fold a PackedReads stream into a table; with ``bucket_steps`` the stream holds
        (bucket_width, PackedReads) pairs (pack_records_bucketed), each extracted by
        ``bucket_steps[width]``. Bit-identical either way."""
        m = metrics or Metrics()
        lane = self.lane(bucket_steps)
        _fold_placed(packed_batches, self.cfg, self.device, [lane], m,
                     bucketed=bucket_steps is not None)
        m.count("unique_kmers", _check_table(lane.state, self.cfg))
        return lane.state


class ScoringTableBuilder:
    """Streaming child-scoring build over a parent-seeded ScoreTable (ops/score.py).

    Same LSM ingest as SampleTableBuilder; the flush carries the packed parental-counts
    column, so finishing the stream leaves candidates one elementwise pass away."""

    def __init__(self, cfg: EngineConfig, device=None, append_packed=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.append_packed = append_packed or make_ingest_step(cfg)

    def call_lane(self, mom: KmerTable, dad: KmerTable, bucket_steps=None) -> FoldLane:
        """The fold lane of the fused call: the scoring table is seeded at a tight
        power-of-two capacity (a sorted table stays valid under truncation to >= n: padding
        sorts last), because every seed row rides every flush sort; the first flush grows it
        to the table capacity. Intermediate windows use the compacting flush (bounded
        staging); the final window stays staged for ``finish_call``. State: (table,
        flushed)."""
        cfg = self.cfg
        seed = seed_score_table(mom, dad, mom.capacity + dad.capacity)
        n_seed = int(seed.n)  # one host sync, before streaming starts
        cap2 = max(1 << (max(n_seed, 1) - 1).bit_length(), 1024)
        if cap2 < seed.capacity:
            seed = ScoreTable(keys=seed.keys[:cap2], counts=seed.counts[:cap2],
                              pcounts=seed.pcounts[:cap2], n=seed.n)

        def flush_fn(acc, state):
            table, flushed = state
            acc, table = flush_score(acc, table,
                                     out_capacity=0 if flushed else cfg.table_capacity)
            return acc, (table, True)

        return FoldLane(cfg, _steps(cfg, self.append_packed, bucket_steps),
                        empty_accumulator(_staging_slots(cfg), cfg.words, self.device),
                        (seed, False), flush_fn, final_flush=False)

    def finish_call(self, lane: FoldLane, metrics: Optional[Metrics] = None):
        """The fused one-sort flush+call (ops/fused.py) on a folded ``call_lane``. →
        (Candidates, n_unique, n_child_unique)."""
        cfg = self.cfg
        m = metrics or Metrics()
        table, flushed = lane.state
        if flushed:
            _check_table(table, cfg, "unique k-mers (child ∪ parents)")
        with m.timer("trio_call"):
            keys, cc, mc, dc, n_unique, n_child_unique = fused_call_full(
                lane.acc, table, cfg.tau_parent, cfg.min_child_count
            )
        cands = Candidates(
            keys=torch.from_numpy(keys.astype(np.int64)),
            child_counts=torch.from_numpy(cc.astype(np.int64)),
            mom_counts=torch.from_numpy(mc.astype(np.int64)),
            dad_counts=torch.from_numpy(dc.astype(np.int64)),
            n=torch.tensor(keys.shape[0], dtype=torch.int64),
        )
        return cands, n_unique, n_child_unique

    def build_call(self, mom: KmerTable, dad: KmerTable, packed_batches: Iterable,
                   metrics: Optional[Metrics] = None, bucket_steps=None):
        """Stream the child and finish with the fused one-sort flush+call (ops/fused.py).

        Returns (Candidates, n_unique, n_child_unique). Only the final window skips
        compaction, so arbitrarily long streams still work. With ``bucket_steps`` the
        stream holds (bucket_width, PackedReads) pairs, extracted by
        ``bucket_steps[width]``."""
        m = metrics or Metrics()
        lane = self.call_lane(mom, dad, bucket_steps)
        _fold_placed(packed_batches, self.cfg, self.device, [lane], m,
                     bucketed=bucket_steps is not None)
        return self.finish_call(lane, m)

    def lane(self, mom: KmerTable, dad: KmerTable) -> FoldLane:
        """The fold lane of the compacting child build: every window folds into a scoring
        table seeded from both parents at the table capacity."""
        cfg = self.cfg
        return FoldLane(cfg, _steps(cfg, self.append_packed, None),
                        empty_accumulator(_staging_slots(cfg), cfg.words, self.device),
                        seed_score_table(mom, dad, cfg.table_capacity), flush_score)

    def child_lane(self, mom: KmerTable, dad: KmerTable, bucket_steps=None) -> FoldLane:
        """The child's fold lane: the fused call's (``call_lane``) where the k geometry
        allows it (``fused_supported``), else the compacting build's (``lane``, unbucketed:
        ``bucket_steps`` must be None)."""
        if fused_supported(self.cfg.k):
            return self.call_lane(mom, dad, bucket_steps)
        assert bucket_steps is None, "the compacting child build streams unbucketed"
        return self.lane(mom, dad)

    def finish(self, lane: FoldLane, metrics: Optional[Metrics] = None
               ) -> Tuple[Candidates, int]:
        """The trio call on a folded ``child_lane``: the fused flush+call, else the checked
        compacted table and ``call_from_score``. → (candidates, child uniques)."""
        if fused_supported(self.cfg.k):
            cands, _n_union, child_uniques = self.finish_call(lane, metrics)
            return cands, child_uniques
        _check_table(lane.state, self.cfg, "unique k-mers (child ∪ parents)")
        return _call_compacted(lane.state, self.cfg, metrics or Metrics())


def packed_batches(source, cfg: EngineConfig,
                   region: Optional[str] = None) -> Iterator[PackedReads]:
    """PackedReads stream from a reads-file path or an open record iterable, through the
    fastest eligible feeder: a plain local BAM with no region takes the C++ decode+pack
    feeder (``io/native.py``) when it builds; a local CRAM with no region takes the columnar
    feeder (``CramReader.iter_seq_chunks`` → ``ops/pack.pack_chunks``, no record objects);
    everything else the Python record loop. The batches are bit-identical either way."""
    if not isinstance(source, str):
        return pack_records(source, cfg)
    if region is None and source.lower().endswith(".bam") and "://" not in source:
        from denovo_kmer_tpu_torch.io import native

        if native.native_available():
            def gen():
                feeder = native.NativeBamFeeder(source, cfg)
                try:
                    yield from feeder
                finally:
                    feeder.close()

            return gen()
    if (region is None and source.lower().endswith(".cram")
            and "://" not in source and cfg.min_base_quality <= 255):
        from denovo_kmer_tpu_torch.io.cram import CramReader
        from denovo_kmer_tpu_torch.io.fasta import load_reference_indexed
        from denovo_kmer_tpu_torch.ops.pack import pack_chunks

        def cram_gen():
            ref = (load_reference_indexed(cfg.reference_fasta)
                   if cfg.reference_fasta else None)
            with open(source, "rb") as f:
                reader = CramReader(f, reference=ref)
                yield from pack_chunks(
                    reader.iter_seq_chunks(
                        cfg.filter_flag_mask, cfg.max_read_len,
                        with_quals=cfg.min_base_quality > 0),
                    cfg)

        return cram_gen()
    return pack_records(_record_stream(source, cfg, region), cfg)


def build_sample_table(
    records,  # record iterable, or a reads-file path
    cfg: EngineConfig,
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    device=None,
    append_packed=None,
) -> KmerTable:
    """Fold a record stream into a k-mer table. Raises TableOverflowError if unique
    k-mers exceed cfg.table_capacity (checked host-side). ``append_packed`` overrides the
    config's ingest step (a multipass pass's filtered step) and keeps the unbucketed
    layout; otherwise ``cfg.read_len_buckets`` takes the bucketed build."""
    builder = SampleTableBuilder(cfg, device, append_packed)
    if cfg.read_len_buckets and append_packed is None:
        return builder.build(_bucketed_stream(records, cfg, region), metrics,
                             make_bucketed_extract_steps(cfg))
    return builder.build(packed_batches(records, cfg, region), metrics)


class _NativeCursorStream:
    """(PackedReads, virtual offset after the batch) from the C++ feeder."""

    def __init__(self, path: str, cfg: EngineConfig):
        from denovo_kmer_tpu_torch.io.native import NativeBamFeeder

        self.feeder = NativeBamFeeder(path, cfg)

    def seek(self, voffset: int) -> None:
        self.feeder.seek_virtual(voffset)

    def close(self) -> None:
        self.feeder.close()

    def __iter__(self):
        while True:
            packed = self.feeder.next_batch()
            if packed is None:
                return
            yield packed, self.feeder.tell_virtual()


class _PythonCursorStream:
    """(PackedReads, virtual offset after the batch) from the Python BAM reader."""

    def __init__(self, path: str, cfg: EngineConfig):
        from denovo_kmer_tpu_torch.io.bam import BamReader

        self.cfg = cfg
        self._fh = open(path, "rb")
        self.reader = BamReader(self._fh)

    def seek(self, voffset: int) -> None:
        self.reader.seek_virtual(voffset)

    def close(self) -> None:
        self._fh.close()

    def __iter__(self):
        from denovo_kmer_tpu_torch.ops.pack import pack_seqs

        cfg = self.cfg
        while True:
            seqs, quals = [], []
            for rec in self.reader:
                if rec.flag & cfg.filter_flag_mask:
                    continue
                seqs.append(rec.seq)
                quals.append(rec.qual)
                if len(seqs) == cfg.batch_reads:
                    break
            if not seqs:
                return
            yield (pack_seqs(seqs, cfg, quals, batch_size=cfg.batch_reads),
                   self.reader.tell_virtual())
            if len(seqs) < cfg.batch_reads:
                return


def packed_stream_with_cursor(path: str, cfg: EngineConfig):
    """(PackedReads, virtual_offset_after_batch) pairs from a BAM, resumable: the returned
    object has ``.seek(voffset)`` (call before iterating) and ``.close()``. The C++ feeder
    when it builds, else the Python reader: the same batches and the same offsets."""
    from denovo_kmer_tpu_torch.io.native import native_available

    if native_available():
        return _NativeCursorStream(path, cfg)
    return _PythonCursorStream(path, cfg)


def build_sample_table_resumable(
    path: str,
    cfg: EngineConfig,
    resume_path: str,
    metrics: Optional[Metrics] = None,
    save_every_flushes: int = 4,
    device=None,
) -> KmerTable:
    """Streaming table build with mid-pass resume.

    Every ``save_every_flushes`` flushes the running table and the BAM virtual-offset
    cursor go to ``resume_path`` (atomically); a killed run restarted with the same
    arguments seeks past the reads already folded and continues. Checkpoints are taken only
    at flush boundaries (empty staging), so the table + cursor pair is exact, and counting
    does not depend on batch boundaries, so the resumed table is bit-identical. The
    finished table is saved with ``done`` set; a rerun then just loads it."""
    from denovo_kmer_tpu_torch.utils.checkpoint import load_resume, save_resume

    dev = resolve_device(device)
    m = metrics or Metrics()
    acc = empty_accumulator(_staging_slots(cfg), cfg.words, dev)
    table = None
    if os.path.exists(resume_path):
        table, cursor, done = load_resume(resume_path, cfg, dev)
        if done:
            return table
    stream = packed_stream_with_cursor(path, cfg)
    if table is None:
        table = empty_table(cfg.table_capacity, cfg.words, dev)
    else:
        stream.seek(cursor)
        m.event("resume", path=resume_path, cursor=cursor)

    last_cursor = None
    flushes_since_save = 0

    def batches(feed):
        nonlocal last_cursor
        for packed, cursor in feed:
            yield cfg.max_read_len, packed
            last_cursor = cursor  # the fold loop has appended this batch

    def save_when_due(table):
        # a flush inside the stream folded every batch up to ``last_cursor``: table and
        # cursor are an exact pair
        nonlocal flushes_since_save
        flushes_since_save += 1
        if flushes_since_save >= save_every_flushes:
            save_resume(resume_path, table, cfg, cursor=last_cursor, done=False)
            m.event("resume_saved", cursor=last_cursor)
            flushes_since_save = 0

    feed_stats: dict = {}
    feed = prefetch_placed(iter(stream), dev, ship_lengths=True, stats=feed_stats)
    lane = FoldLane(cfg, {cfg.max_read_len: make_ingest_step(cfg)}, acc, table, flush)
    try:
        _fold_stream(batches(feed), [lane], m, after_flush=save_when_due)
    finally:
        feed.close()  # stop the prefetch threads before closing their input
        close_unless_leaked(stream, feed_stats)
    _report_feed_stats(m, feed_stats)
    table = lane.state
    n = _check_table(table, cfg)
    save_resume(resume_path, table, cfg, cursor=-1, done=True)
    m.count("unique_kmers", n)
    return table


def decode_kmers_np(keys: np.ndarray, k: int) -> List[str]:
    """Vectorized multi-word k-mer decode → ACGT strings (host, for reporting)."""
    n, W = keys.shape
    if n == 0:
        return []
    # bit position (from LSB of the big-endian word vector) for base j is 2*(k-1-j)
    out = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        bit = 2 * (k - 1 - j)
        w = W - 1 - bit // 32
        sh = bit % 32
        code = (keys[:, w] >> np.uint32(sh)) & np.uint32(3)
        out[:, j] = _BASE[code]
    return [bytes(row).decode() for row in out]


def format_report_np(
    keys: np.ndarray,
    child_counts: np.ndarray,
    mom_counts: np.ndarray,
    dad_counts: np.ndarray,
    k: int,
) -> str:
    """Byte-exact TSV report (SPEC_SEMANTICS §7), identical to oracle.format_report."""
    lines = ["#kmer\tchild_count\tmom_count\tdad_count"]
    strs = decode_kmers_np(keys, k)
    for i, s in enumerate(strs):
        lines.append(f"{s}\t{child_counts[i]}\t{mom_counts[i]}\t{dad_counts[i]}")
    return "\n".join(lines) + "\n"


def _parent_tables(mom_path: str, dad_path: str, cfg: EngineConfig, m: Metrics,
                   region: Optional[str], dev: torch.device,
                   append_packed=None) -> Dict[str, KmerTable]:
    """The parents' tables: a `count` checkpoint (``.npz``) loads and skips the parent's
    pass; reads build (bucketed where the config says so, unless ``append_packed`` gives
    the ingest step)."""
    tables = {}
    for name, path in (("mom", mom_path), ("dad", dad_path)):
        loaded = maybe_load_flat_table(path, cfg, dev)
        if loaded is not None:
            tables[name] = loaded
            m.event("table_loaded", sample=name, path=path)
        else:
            with m.timer(f"build_{name}"):
                tables[name] = build_sample_table(path, cfg, m, region=region, device=dev,
                                                  append_packed=append_packed)
        m.event("table_built", sample=name, unique=int(tables[name].n))
    return tables


def run_trio(
    mom_path: str,
    dad_path: str,
    child_path: str,
    cfg: EngineConfig,
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    device=None,
) -> TrioResult:
    """Full single-device trio workflow. ``device=None`` runs on the card. A parent given as
    a `count` checkpoint (``.npz``) is loaded instead of built. Length buckets need a k the
    fused call takes: the compacting child build (``2k % 32 == 0``) has no bucketed variant,
    and the JAX package's ``run_trio`` fails on that combination too."""
    if cfg.read_len_buckets and not fused_supported(cfg.k):
        raise ValueError(f"read_len_buckets with k={cfg.k}: a k whose 2k bits fill whole key "
                         "words takes the compacting child build, which has no bucketed "
                         "variant; use another k, or --passes 2 or more")
    dev = resolve_device(device)
    m = metrics or Metrics()
    tables = _parent_tables(mom_path, dad_path, cfg, m, region, dev)

    cands, child_uniques = score_child(cfg, dev, tables["mom"], tables["dad"], child_path, m,
                                       region)
    tables_n = {"mom": int(tables["mom"].n), "dad": int(tables["dad"].n),
                "child": child_uniques}
    return _trio_result(_candidate_parts(cands), cfg.k, m, tables_n)


def score_child(cfg: EngineConfig, dev: torch.device, mom: KmerTable, dad: KmerTable,
                child_path: str, m: Metrics, region: Optional[str] = None,
                append_packed=None, bucket_steps=None) -> Tuple[Candidates, int]:
    """The child against its parents' tables: the parent-seeded scored build (ops/score.py),
    whose final window runs the one-sort fused flush+call (ops/fused.py) where the k
    geometry allows it, else the compacting build (unbucketed) and ``call_from_score``.
    ``append_packed`` and ``bucket_steps`` override the config's ingest steps (a multipass
    pass's filtered steps). → (candidates, child uniques)."""
    scorer = ScoringTableBuilder(cfg, dev, append_packed)
    if not fused_supported(cfg.k):
        bucket_steps = None
    elif bucket_steps is None and cfg.read_len_buckets:
        bucket_steps = make_bucketed_extract_steps(cfg)
    child_batches = (_bucketed_stream(child_path, cfg, region) if bucket_steps
                     else packed_batches(child_path, cfg, region))
    with m.timer("build_child"):
        lane = scorer.child_lane(mom, dad, bucket_steps)
        _fold_placed(child_batches, cfg, dev, [lane], m, bucketed=bucket_steps is not None)
        cands, child_uniques = scorer.finish(lane, m)
    m.event("table_built", sample="child", unique=child_uniques)
    return cands, child_uniques


def _call_compacted(score_tab: ScoreTable, cfg: EngineConfig,
                    m: Metrics) -> Tuple[Candidates, int]:
    """The trio call on a compacted scoring table. → (candidates, child uniques)."""
    child_uniques = int((score_tab.counts >= 1).sum())
    with m.timer("trio_call"):
        cands = call_from_score(score_tab, cfg.tau_parent, cfg.min_child_count)
    return cands, child_uniques


def _trio_result(parts, k: int, m: Metrics, tables_n: Dict[str, int]) -> TrioResult:
    """The TrioResult of host uint32 (keys, child, mom, dad) candidate columns in report
    order."""
    keys, cc, mc, dc = parts
    n = keys.shape[0]
    cand_tuples = [
        (words_to_kmer_value(keys[i]), int(cc[i]), int(mc[i]), int(dc[i]))
        for i in range(n)
    ]
    m.count("candidates", n)
    return TrioResult(candidates=cand_tuples, report=format_report_np(keys, cc, mc, dc, k),
                      metrics=m, tables_n=tables_n)


def _candidate_parts(cands: Candidates):
    """Host uint32 (keys, child, mom, dad) of the candidates."""
    n = int(cands.n)
    return tuple(t[:n].cpu().numpy().astype(np.uint32)
                 for t in (cands.keys, cands.child_counts, cands.mom_counts,
                           cands.dad_counts))


def _merge_pass_results(parts: List[tuple], cfg: EngineConfig, m: Metrics,
                        tables_n: Dict[str, int]) -> TrioResult:
    """Union of per-pass candidates in report order: each pass's list is key-ascending
    over a disjoint key set, and ascending k-mer value is lexicographic big-endian word
    order."""
    if parts:
        keys, cc, mc, dc = (np.concatenate(col) for col in zip(*parts))
    else:
        keys = np.zeros((0, cfg.words), np.uint32)
        cc = mc = dc = np.zeros((0,), np.uint32)
    order = np.lexsort(tuple(keys[:, w] for w in reversed(range(cfg.words))))
    return _trio_result((keys[order], cc[order], mc[order], dc[order]), cfg.k, m, tables_n)


def _filter_table_by_pass(table: KmerTable, n_passes: int, pass_id: int) -> KmerTable:
    """Restrict a full (checkpointed) table to one hash-pass bucket: a host-side compaction
    (a sorted table's subset stays sorted). Lets `count` checkpoints feed multipass runs."""
    keys, counts, n = table_to_numpy(table)
    C, W = keys.shape
    keys, counts = keys[:n], counts[:n]
    if n:
        sel = (pass_of(torch.from_numpy(keys.astype(np.int64)), n_passes) == pass_id).numpy()
        keys, counts = keys[sel], counts[sel]
    out_k = np.full((C, W), 0xFFFFFFFF, np.uint32)
    out_c = np.zeros((C,), np.uint32)
    out_k[: len(keys)] = keys
    out_c[: len(keys)] = counts
    return table_from_numpy(out_k, out_c, len(keys), table.keys.device)


def run_trio_multipass(
    mom_path: str,
    dad_path: str,
    child_path: str,
    cfg: EngineConfig,
    n_passes: int,
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    device=None,
) -> TrioResult:
    """WGS-scale trio call: time-multiplexed hash-pass partition (re-decode mode).

    A 30x human WGS trio holds ~2.5-3G unique k-mers, far beyond one device table. Pass p
    keeps only k-mers whose ``router.pass_of`` bucket is p (the extraction kernel's pass
    filter), so each pass's table holds ~1/n_passes of the uniques and
    ``cfg.table_capacity`` only needs to cover that slice; the streams are re-read every
    pass. The pass partition is a partition of the key space, so the union of per-pass
    candidates is exactly the single-pass result. Length buckets compose with passes
    (per-(width, pass) steps); a `count` checkpoint parent is filtered to each pass's keys.
    ``device=None`` runs on the card."""
    if n_passes < 2:
        return run_trio(mom_path, dad_path, child_path, cfg, metrics, region, device)
    dev = resolve_device(device)
    m = metrics or Metrics()
    step = make_ingest_step(cfg, n_passes)
    bucket_steps_pp = (make_bucketed_extract_steps(cfg, n_passes)
                       if cfg.read_len_buckets else None)
    loaded = {name: maybe_load_flat_table(path, cfg, dev)
              for name, path in (("mom", mom_path), ("dad", dad_path))}
    parts = []
    tables_n = {"mom": 0, "dad": 0, "child": 0}
    for p in range(n_passes):
        pass_step = _pass_steps(step, p)
        pass_bucket_steps = (_pass_steps(bucket_steps_pp, p)
                             if bucket_steps_pp is not None else None)
        ptables = {}
        for name, path in (("mom", mom_path), ("dad", dad_path)):
            if loaded[name] is not None:
                # `count` checkpoints hold the FULL table: slice this pass's keys out
                ptables[name] = _filter_table_by_pass(loaded[name], n_passes, p)
            elif pass_bucket_steps is not None:
                with m.timer(f"build_{name}"):
                    ptables[name] = SampleTableBuilder(cfg, dev, pass_step).build(
                        _bucketed_stream(path, cfg, region), m, pass_bucket_steps)
            else:
                with m.timer(f"build_{name}"):
                    ptables[name] = build_sample_table(path, cfg, m, region, dev, pass_step)
            tables_n[name] += int(ptables[name].n)
        cands, n_child = score_child(cfg, dev, ptables["mom"], ptables["dad"], child_path, m,
                                     region, pass_step, pass_bucket_steps)
        tables_n["child"] += n_child
        parts.append(_candidate_parts(cands))
        n = parts[-1][0].shape[0]
        m.event("pass_done", pass_id=p, candidates=n)
    return _merge_pass_results(parts, cfg, m, tables_n)


def _spill_stream(path: str, cfg: EngineConfig, n_passes: int, sink, cap: int, m: Metrics,
                  device: torch.device, append_packed, region=None, bucket_steps=None) -> int:
    """Decode and extract ``path`` ONCE, partitioning each full staging window by hash
    pass (``ops/spill.partition_window``) and handing (disp, counts) device tensors to
    ``sink``. Returns the total partition overflow (checked by the caller — loud failure,
    never silent loss). With ``bucket_steps`` the stream is length-bucketed, and window
    fullness is tracked in staged windows, as the bucketed table builds do."""
    from denovo_kmer_tpu_torch.ops.spill import partition_window

    def partition(acc, overflow):
        disp, counts, ovf, acc = partition_window(acc, n_passes, cap)
        sink(disp, counts)
        return acc, overflow + ovf

    if bucket_steps is not None:
        stream = _bucketed_stream(path, cfg, region)
    else:
        stream = packed_batches(path, cfg, region)
    feed_stats: dict = {}
    feed, items = _placed_items(stream, cfg, device, bucket_steps is not None, feed_stats)
    lane = FoldLane(cfg, _steps(cfg, append_packed, bucket_steps),
                    empty_accumulator(_staging_slots(cfg), cfg.words, device),
                    torch.zeros((), dtype=torch.int64, device=device), partition)
    try:
        _fold_stream(items, [lane], m, timer="extract_spill")
    finally:
        feed.close()  # stop the prefetch threads before closing their input
        close_unless_leaked(stream, feed_stats)
    _report_feed_stats(m, feed_stats)
    return int(lane.state)


def run_trio_spill(
    mom_path: str,
    dad_path: str,
    child_path: str,
    cfg: EngineConfig,
    n_passes: int,
    spill_dir: Optional[str] = None,
    device_store_rows: Optional[int] = None,
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    capacity_factor: float = 1.4,
    device=None,
) -> TrioResult:
    """WGS-scale trio call by SINGLE-DECODE multipass (``ops/spill.py``).

    Where ``run_trio_multipass`` decodes and extracts every stream n_passes times, this
    decodes and extracts each sample once, splits the extracted k-mers into per-pass
    spills with one partition (the partition kernel) per window, and counts each pass from
    its own spill. Length buckets compose with it (each sample is decoded bucketed once).

    ``spill_dir``: host spill files (raw 4W-byte rows per k-mer + manifest; resume: a sample
    whose manifest matches is never re-decoded). Otherwise ``device_store_rows`` sizes a
    device store (rows PER PASS; ``SpillOverflowError`` names the fix when it does not
    fit). The candidate union across passes is exactly the single-pass result.
    ``device=None`` runs on the card."""
    from denovo_kmer_tpu_torch.ops.spill import (
        HostSpill,
        SpillOverflowError,
        _fold_chunk,
        _fold_chunk_score,
        alloc_pass_rows,
        count_pass_from_store,
        empty_pass_store,
        score_pass_from_store,
        source_signature,
        spill_capacity,
        store_append,
    )

    if n_passes < 2:
        return run_trio(mom_path, dad_path, child_path, cfg, metrics, region, device)
    if (spill_dir is None) == (device_store_rows is None):
        raise ValueError("exactly one of spill_dir / device_store_rows is required")
    append_packed = make_ingest_step(cfg)
    bucket_steps = make_bucketed_extract_steps(cfg) if cfg.read_len_buckets else None
    dev = resolve_device(device)
    if dev.type == "cuda" and n_passes + 1 > MAX_SPILL_BUCKETS:
        raise ValueError(f"{n_passes} passes: the partition kernel takes at most "
                         f"{MAX_SPILL_BUCKETS - 1} (ROADMAP.md §3)")
    m = metrics or Metrics()
    slots = _staging_slots(cfg)
    cap = spill_capacity(slots, n_passes, capacity_factor)
    chunk_rows = slots

    def overflow_error(ovf, name):
        return SpillOverflowError(
            f"{ovf} k-mers overflowed the per-pass window capacity {cap} "
            f"({name}); raise capacity_factor (={capacity_factor})")

    spills = {}
    for name, path in (("mom", mom_path), ("dad", dad_path), ("child", child_path)):
        if spill_dir is not None:
            hs = HostSpill(spill_dir, name, n_passes, cfg.words, cfg.config_hash(),
                           source_sig=source_signature(path, cfg, region))
            if hs.complete():
                m.event("spill_reused", sample=name, rows=sum(hs.counts))
                spills[name] = hs
                continue
            hs.open_for_write()
            try:
                with m.timer(f"spill_{name}"):
                    ovf = _spill_stream(path, cfg, n_passes, hs.append_window, cap, m,
                                        dev, append_packed, region, bucket_steps)
            except BaseException:
                hs.abort()
                raise
            if ovf:
                hs.abort()
                raise overflow_error(ovf, name)
            hs.finish()
            m.event("spill_written", sample=name, rows=sum(hs.counts))
            spills[name] = hs
        else:
            rows_pp = -(-device_store_rows // chunk_rows) * chunk_rows
            # +1 window-capacity of slack (PassStore); the logical budget for the
            # overflow guard below stays rows_pp
            store = empty_pass_store(n_passes, alloc_pass_rows(rows_pp, cap, chunk_rows),
                                     cfg.words, dev)

            def dev_sink(d, c):
                nonlocal store
                store = store_append(store, d, c)

            with m.timer(f"spill_{name}"):
                ovf = _spill_stream(path, cfg, n_passes, dev_sink, cap, m, dev,
                                    append_packed, region, bucket_steps)
            if ovf:
                raise overflow_error(ovf, name)
            if max(store.fill, default=0) > rows_pp:
                raise SpillOverflowError(
                    f"device store overflow: pass holds {max(store.fill)} rows > "
                    f"{rows_pp}; raise device_store_rows")
            m.event("spill_stored", sample=name, rows=sum(store.fill))
            spills[name] = store

    # ---- per-pass counting from the spills (no decode, no extract) ----
    C = cfg.table_capacity

    def host_chunks(sp, p):
        for buf, take in sp.read_chunks(p, chunk_rows):
            yield torch.from_numpy(buf.view(np.int32)).to(dev), take

    def fold_table(sp, p):
        table = empty_table(C, cfg.words, dev)
        if isinstance(sp, HostSpill):
            for rows, take in host_chunks(sp, p):
                table = _fold_chunk(rows, table, take)
        else:
            table = count_pass_from_store(sp, p, table, chunk_rows)
        return table, _check_table(table, cfg)

    parts = []
    tables_n = {"mom": 0, "dad": 0, "child": 0}
    for p in range(n_passes):
        with m.timer("count_passes"):
            mom_p, n_m = fold_table(spills["mom"], p)
            dad_p, n_d = fold_table(spills["dad"], p)
            tables_n["mom"] += n_m
            tables_n["dad"] += n_d
            stab = seed_score_table(mom_p, dad_p, C)
            sp = spills["child"]
            if isinstance(sp, HostSpill):
                for rows, take in host_chunks(sp, p):
                    stab = _fold_chunk_score(rows, stab, take)
            else:
                stab = score_pass_from_store(sp, p, stab, chunk_rows)
            _check_table(stab, cfg)
            tables_n["child"] += int((stab.counts >= 1).sum())
            cands = call_from_score(stab, cfg.tau_parent, cfg.min_child_count)
            parts.append(_candidate_parts(cands))
            n = parts[-1][0].shape[0]
        m.event("pass_done", pass_id=p, candidates=n)
    return _merge_pass_results(parts, cfg, m, tables_n)


# ---------------------------------------------------------------------------------------
# evidence: the child reads that hold a candidate k-mer
# ---------------------------------------------------------------------------------------

def parse_candidates_tsv(path: str) -> List[Tuple[str, int]]:
    """(kmer, child_count) rows of a `call` report TSV (``#``-prefixed header skipped;
    count 0 when the column is absent). The one parser of the candidate-TSV text format:
    evidence and sites both build on it. Non-numeric count columns parse as 0 with one
    stderr warning, so all-zero child counts downstream are never silent."""
    out: List[Tuple[str, int]] = []
    bad_counts = 0
    first_bad = None
    with open(path, "rt") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            try:  # tolerate non-numeric second columns (hand-made TSVs)
                count = int(parts[1]) if len(parts) > 1 else 0
            except ValueError:
                count = 0
                bad_counts += 1
                if first_bad is None:
                    first_bad = (lineno, parts[1][:40])
            out.append((parts[0].upper(), count))
    if bad_counts:
        print(f"denovo-kmer: {path}: {bad_counts} row(s) with a non-numeric "
              f"count column (first: line {first_bad[0]}, {first_bad[1]!r}) "
              f"— treated as count 0; check the file's delimiter/columns",
              file=sys.stderr)
    return out


def candidate_words_from_tsv(path: str, cfg: EngineConfig) -> np.ndarray:
    """Candidate k-mer strings (parse_candidates_tsv) → (N, W) uint32 canonical word rows."""
    from denovo_kmer_tpu_torch.oracle.scalar import (
        canonical_value,
        encode_kmer,
        kmer_value_to_words,
    )

    rows = []
    for s, _count in parse_candidates_tsv(path):
        if len(s) != cfg.k:
            raise ValueError(
                f"{path}: candidate {s[:40]!r} has length {len(s)}, expected k={cfg.k}")
        v = encode_kmer(s)
        if cfg.canonical:
            v = canonical_value(v, cfg.k)
        rows.append(kmer_value_to_words(v, cfg.k))
    return np.asarray(rows, np.uint32).reshape(len(rows), cfg.words)


def candidate_table(words: np.ndarray, device="cpu") -> KmerTable:
    """Small sorted membership table from (N, W) candidate rows, built on the host (N is
    the candidate count, thousands at most; ``probe_table`` binary-searches it)."""
    n, W = words.shape
    if n:
        order = np.lexsort(tuple(words[:, w] for w in range(W - 1, -1, -1)))
        rows = words[order]
        keep = np.ones(n, bool)
        keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
        rows = rows[keep]
        n = len(rows)
    else:
        rows = words
    cap = max(1 << max(int(n - 1).bit_length(), 1), 2)
    keys = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    keys[:n] = rows
    return table_from_numpy(keys, (np.arange(cap) < n).astype(np.uint32), n, device)


def candidate_read_batches(child_path: str, table: KmerTable, cfg: EngineConfig,
                           region: Optional[str] = None) -> Iterator[Tuple[list, np.ndarray]]:
    """The device step of evidence and sites: the child's records that pass the record
    filter, in batches of ``cfg.batch_reads``, each with the host bool mask of its reads that
    hold a valid window whose (canonical) k-mer is in ``table``. Row r of a packed batch is
    read r of the batch, so records and windows stay aligned (the filter runs here, not in
    ``pack_records``). On the table's device one ``extract_append`` into a scratch buffer of
    ``batch_reads × P`` rows at fill 0 writes window (b, p) at row b·P + p: the (B, P, W)
    keys and (B, P) validity the probe (``ops/table.probe_table``) takes."""
    from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor
    from denovo_kmer_tpu_torch.ops.pack import pack_seqs
    from denovo_kmer_tpu_torch.ops.table import probe_table

    records = _record_stream(child_path, cfg, region)
    dev = table.keys.device
    B, P, W = cfg.batch_reads, cfg.windows_per_read, cfg.words
    scratch = empty_accumulator(B * P, W, dev)

    def hits(batch: list) -> np.ndarray:
        packed = pack_seqs([r.seq for r in batch], cfg, [r.qual for r in batch], batch_size=B)
        acc = _extract_append(scratch, as_int32_tensor(packed.words).to(dev),
                              as_int32_tensor(packed.vwords).to(dev), None, cfg.k,
                              cfg.max_read_len, cfg.canonical)
        hit = (probe_table(table, acc.kmers.view(B, P, W)) > 0) & acc.valid.view(B, P)
        return hit.any(dim=-1).cpu().numpy()[: len(batch)]

    def batches():
        batch: list = []
        for rec in records:
            if rec.flag & cfg.filter_flag_mask:
                continue
            batch.append(rec)
            if len(batch) == B:
                yield batch, hits(batch)
                batch = []
        if batch:
            yield batch, hits(batch)

    return batches()


def _engine_view_of_seq(r, cfg: EngineConfig) -> str:
    """The sequence as the device saw it: truncated to max_read_len, with bases below
    min_base_quality masked to N (ops/pack semantics), so host attribution can never credit
    a k-mer the engine itself dropped."""
    s = r.seq[: cfg.max_read_len]
    if cfg.min_base_quality > 0 and r.qual is not None:
        s = "".join("N" if q < cfg.min_base_quality else b for b, q in zip(s, r.qual))
    return s


def record_as_bam(r, ordinal: int):
    """Sequence-level BamRecord for sources without alignment fields (nameless or refless
    evidence rows)."""
    from denovo_kmer_tpu_torch.io.bam import BamRecord

    if isinstance(r, BamRecord):
        return r
    return BamRecord(name=getattr(r, "name", None) or f"r{ordinal}",
                     flag=getattr(r, "flag", 4) | 4, seq=r.seq, qual=r.qual)


def source_header(path: str):
    """(references, SAM header text) of a reads source: ([], a default header) when the
    format has none (FASTQ/FASTA). Reads the header only; URLs through
    ``io/remote.open_binary``."""
    low = path.lower()
    default = "@HD\tVN:1.6\tSO:unsorted\n"
    from denovo_kmer_tpu_torch.io.remote import open_binary

    if low.endswith(".bam"):
        from denovo_kmer_tpu_torch.io.bam import BamReader

        with open_binary(path) as f:
            r = BamReader(f)
            return r.references, (r.header_text or default)
    if low.endswith(".cram"):
        from denovo_kmer_tpu_torch.io.cram import CramReader

        with open_binary(path) as f:
            r = CramReader(f)
            return r.references, (r.sam_header or default)
    if low.endswith((".sam", ".sam.gz")):
        from denovo_kmer_tpu_torch.io.sam import SamReader

        with SamReader(path) as sr:
            hdr = "\n".join(sr.header_lines)
            return list(sr.references), (hdr + "\n" if hdr else default)
    return [], default


def source_references(path: str) -> list:
    """(name, length) reference dictionary of a reads source, [] when the format has none
    (FASTQ/FASTA)."""
    return source_header(path)[0]


@dataclasses.dataclass
class EvidenceResult:
    n_reads_scanned: int
    n_reads_matched: int
    out_path: str


def run_evidence(
    child_path: str,
    candidates_tsv: str,
    cfg: EngineConfig,
    out_path: str,
    region: Optional[str] = None,
    per_candidate_out: Optional[str] = None,
    device=None,
) -> EvidenceResult:
    """Write the child reads that contain any candidate k-mer (forward or reverse
    complement, the call's canonical semantics) to ``out_path`` (.bam, .sam text, or
    .fastq/.fq for sequence-only output): the supporting-evidence subset every de novo
    candidate review needs. On the device it is the extraction kernel and one
    binary-search probe a window (``candidate_read_batches``); the records ride along on
    the host. ``per_candidate_out`` also writes, for each candidate, the names of the
    matched reads that hold it. ``device=None`` runs on the card."""
    from denovo_kmer_tpu_torch.io.bam import BamRecord, BamWriter

    dev = resolve_device(device)
    table = candidate_table(candidate_words_from_tsv(candidates_tsv, cfg), dev)
    low_out = out_path.lower()
    fastq = low_out.endswith((".fastq", ".fq"))
    sam_text = low_out.endswith(".sam")
    scanned = matched = 0
    matched_reads: list = []  # (name, seq), only kept for per_candidate_out

    # BAM/SAM output needs the source's reference dictionary: records keep their refid,
    # and a BAM whose refid >= n_ref is structurally invalid
    references = [] if fastq else source_references(child_path)
    n_ref = len(references)
    ref_names = [n for n, _ in references]
    batches = candidate_read_batches(child_path, table, cfg, region)

    if sam_text:
        from denovo_kmer_tpu_torch.io.sam import format_sam_record, sam_header_lines

        out_f = open(out_path, "w")
        out_f.write("\n".join(sam_header_lines(references)) + "\n")
        writer = None
    else:
        out_f = open(out_path, "wb")
        writer = None if fastq else BamWriter(out_f, references=references)
    try:
        for batch, mask in batches:
            for i, (r, hit) in enumerate(zip(batch, mask)):
                ordinal = scanned + i
                if not hit:
                    continue
                matched += 1
                name = getattr(r, "name", None) or f"r{ordinal}"
                if per_candidate_out is not None:
                    matched_reads.append((name, _engine_view_of_seq(r, cfg)))
                if fastq:
                    q = r.qual if r.qual is not None else (0,) * len(r.seq)
                    qs = "".join(chr(min(x, 93) + 33) for x in q)
                    out_f.write(f"@{name}\n{r.seq}\n+\n{qs}\n".encode())
                elif sam_text:
                    out_f.write(format_sam_record(record_as_bam(r, ordinal), ref_names) + "\n")
                elif isinstance(r, BamRecord) and r.refid < n_ref:
                    writer.write(r)
                else:  # nameless/refless sources: sequence-level evidence rows
                    writer.write(record_as_bam(r, ordinal))
            scanned += len(batch)
    finally:
        if writer is not None:
            writer.close()
        out_f.close()
    if per_candidate_out is not None:
        _write_per_candidate(candidates_tsv, matched_reads, per_candidate_out)
    return EvidenceResult(n_reads_scanned=scanned, n_reads_matched=matched,
                          out_path=out_path)


def _write_per_candidate(candidates_tsv: str, matched_reads: list, out_path: str) -> None:
    """candidate → supporting read names: the matched subset is small, so a host substring
    scan (forward and reverse complement, the call's canonical semantics) is exact."""
    rc = str.maketrans("ACGT", "TGCA")
    cands = []
    with open(candidates_tsv) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                cands.append(line.split("\t")[0].upper())
    with open(out_path, "w") as f:
        f.write("#kmer\tn_reads\treads\n")
        for c in cands:
            pats = (c, c.translate(rc)[::-1])
            names = [n for n, s in matched_reads if pats[0] in s or pats[1] in s]
            f.write(f"{c}\t{len(names)}\t{','.join(names)}\n")
