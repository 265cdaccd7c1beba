"""End-to-end trio pipeline: BAM/FASTQ streams → parental tables → child scoring → report.

Port of the single-device path of ``denovo_kmer_tpu/pipeline.py`` (``run_trio``): the host
feeder decodes and 2-bit-packs read batches, the extraction kernel appends each batch's
canonical k-mers to a staging buffer on the device, LSM flushes fold the staging buffer into
sorted count tables, the child is scored against a parent-seeded table and the final window
runs the fused one-sort call; only the candidate set crosses back to the host for the TSV.

Entry points run on the card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.io.fasta import read_fasta, read_fastq
from denovo_kmer_tpu_torch.io.prefetch import prefetch_placed
from denovo_kmer_tpu_torch.ops.extract import extract_append as _extract_append
from denovo_kmer_tpu_torch.ops.fused import fused_call_full, fused_supported
from denovo_kmer_tpu_torch.ops.pack import PackedReads, pack_records
from denovo_kmer_tpu_torch.ops.score import (
    ScoreTable,
    call_from_score,
    flush_score,
    seed_score_table,
)
from denovo_kmer_tpu_torch.ops.stream import empty_accumulator, flush
from denovo_kmer_tpu_torch.ops.table import KmerTable, empty_table
from denovo_kmer_tpu_torch.ops.trio import Candidates
from denovo_kmer_tpu_torch.oracle.scalar import words_to_kmer_value
from denovo_kmer_tpu_torch.utils.metrics import Metrics

_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

_NOT_YET = "not yet ported to the PyTorch/CUDA package (see ROADMAP.md)"


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
    """Open a reads file as a record stream (BAM/FASTQ/FASTA by extension)."""
    if region:
        raise NotImplementedError(f"--region: {_NOT_YET}")
    low = path.lower()
    if low.endswith(".bam"):
        return read_bam_records(path)
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
    if low.endswith((".sam", ".sam.gz", ".cram")):
        raise NotImplementedError(f"SAM/CRAM input ({path}): {_NOT_YET}")
    raise ValueError(f"unrecognized reads file extension: {path}")


def make_ingest_step(cfg: EngineConfig):
    """The per-batch ingest step of a config: ``append_packed(acc, packed)`` extracts a
    placed batch straight into the staging buffer — length-shipped (``vwords is None``)
    or with its validity words. The JAX package's ``extractor`` field picks a TPU layout;
    here every value runs the same CUDA kernel."""
    if cfg.read_len_buckets:
        raise NotImplementedError(f"read_len_buckets: {_NOT_YET}")

    def append_packed(acc, packed: PackedReads):
        lengths = packed.length if packed.vwords is None else None
        return _extract_append(acc, packed.words, packed.vwords, lengths,
                               cfg.k, cfg.max_read_len, cfg.canonical)

    return append_packed


def _staging_slots(cfg: EngineConfig) -> int:
    return cfg.accum_batches * cfg.batch_reads * cfg.windows_per_read


class SampleTableBuilder:
    """Streams one sample's packed batches into its k-mer table."""

    def __init__(self, cfg: EngineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.append_packed = make_ingest_step(cfg)

    def build(self, packed_batches: Iterable, metrics: Optional[Metrics] = None) -> KmerTable:
        cfg = self.cfg
        m = metrics or Metrics()
        acc = empty_accumulator(_staging_slots(cfg), cfg.words, self.device)
        table = empty_table(cfg.table_capacity, cfg.words, self.device)
        pending = 0
        feed_stats: dict = {}
        for packed in prefetch_placed(packed_batches, self.device, ship_lengths=True,
                                      stats=feed_stats):
            m.count("reads_ingested", packed.n_reads)
            with m.timer("extract_probe"):
                acc = self.append_packed(acc, packed)
                pending += 1
                if pending == cfg.accum_batches:
                    acc, table = flush(acc, table)
                    pending = 0
            m.count("kmers_extracted", packed.n_reads * cfg.windows_per_read)
            m.count("batches", 1)
        if pending:
            with m.timer("extract_probe"):
                acc, table = flush(acc, table)
        _report_feed_stats(m, feed_stats)
        n = int(table.n)
        if n > cfg.table_capacity:
            raise TableOverflowError(_overflow_msg(n, cfg.table_capacity))
        m.count("unique_kmers", n)
        return table


class ScoringTableBuilder:
    """Streaming child-scoring build over a parent-seeded ScoreTable (ops/score.py).

    Same LSM ingest as SampleTableBuilder; the flush carries the packed parental-counts
    column, so finishing the stream leaves candidates one elementwise pass away."""

    def __init__(self, cfg: EngineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.append_packed = make_ingest_step(cfg)

    def build_call(self, mom: KmerTable, dad: KmerTable, packed_batches: Iterable,
                   metrics: Optional[Metrics] = None):
        """Stream the child and finish with the fused one-sort flush+call (ops/fused.py).

        Returns (Candidates, n_unique, n_child_unique). The scoring table is seeded at a
        tight power-of-two capacity (a sorted table stays valid under truncation to >= n:
        padding sorts last), because every seed row rides every flush sort. Intermediate
        windows use the compacting flush (bounded staging); only the final window skips
        compaction, so arbitrarily long streams still work.
        """
        cfg = self.cfg
        m = metrics or Metrics()
        acc = empty_accumulator(_staging_slots(cfg), cfg.words, self.device)
        seed = seed_score_table(mom, dad, mom.capacity + dad.capacity)
        n_seed = int(seed.n)  # one host sync, before streaming starts
        cap2 = max(1 << (max(n_seed, 1) - 1).bit_length(), 1024)
        if cap2 < seed.capacity:
            seed = ScoreTable(keys=seed.keys[:cap2], counts=seed.counts[:cap2],
                              pcounts=seed.pcounts[:cap2], n=seed.n)
        table = seed
        slots = _staging_slots(cfg)
        win = cfg.batch_reads * cfg.windows_per_read
        fill = 0
        flushed = False
        feed_stats: dict = {}
        for packed in prefetch_placed(packed_batches, self.device, ship_lengths=True,
                                      stats=feed_stats):
            m.count("reads_ingested", packed.n_reads)
            with m.timer("extract_probe"):
                if fill + win > slots:
                    # the first flush grows the tight seed to the full table capacity
                    acc, table = flush_score(
                        acc, table, out_capacity=0 if flushed else cfg.table_capacity)
                    fill = 0
                    flushed = True
                acc = self.append_packed(acc, packed)
                fill += win
            m.count("kmers_extracted", packed.n_reads * cfg.windows_per_read)
            m.count("batches", 1)
        _report_feed_stats(m, feed_stats)
        if flushed and int(table.n) > cfg.table_capacity:
            raise TableOverflowError(
                _overflow_msg(int(table.n), cfg.table_capacity,
                              "unique k-mers (child ∪ parents)")
            )
        with m.timer("trio_call"):
            keys, cc, mc, dc, n_unique, n_child_unique = fused_call_full(
                acc, table, cfg.tau_parent, cfg.min_child_count
            )
        cands = Candidates(
            keys=torch.from_numpy(keys.astype(np.int64)),
            child_counts=torch.from_numpy(cc.astype(np.int64)),
            mom_counts=torch.from_numpy(mc.astype(np.int64)),
            dad_counts=torch.from_numpy(dc.astype(np.int64)),
            n=torch.tensor(keys.shape[0], dtype=torch.int64),
        )
        return cands, n_unique, n_child_unique

    def build(self, mom: KmerTable, dad: KmerTable, packed_batches: Iterable,
              metrics: Optional[Metrics] = None) -> ScoreTable:
        cfg = self.cfg
        m = metrics or Metrics()
        acc = empty_accumulator(_staging_slots(cfg), cfg.words, self.device)
        table = seed_score_table(mom, dad, cfg.table_capacity)
        pending = 0
        for packed in prefetch_placed(packed_batches, self.device, ship_lengths=True):
            m.count("reads_ingested", packed.n_reads)
            with m.timer("extract_probe"):
                acc = self.append_packed(acc, packed)
                pending += 1
                if pending == cfg.accum_batches:
                    acc, table = flush_score(acc, table)
                    pending = 0
            m.count("kmers_extracted", packed.n_reads * cfg.windows_per_read)
            m.count("batches", 1)
        if pending:
            with m.timer("extract_probe"):
                acc, table = flush_score(acc, table)
        n = int(table.n)
        if n > cfg.table_capacity:
            raise TableOverflowError(
                _overflow_msg(n, cfg.table_capacity, "unique k-mers (child ∪ parents)")
            )
        return table


def packed_batches(source, cfg: EngineConfig,
                   region: Optional[str] = None) -> Iterator[PackedReads]:
    """PackedReads stream from a reads-file path or an open record iterable, through the
    pure-Python decoder (the JAX package's C++ feeder comes with a later slice)."""
    if not isinstance(source, str):
        return pack_records(source, cfg)
    return pack_records(_record_stream(source, cfg, region), cfg)


def build_sample_table(
    records,  # record iterable, or a reads-file path
    cfg: EngineConfig,
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    device=None,
) -> KmerTable:
    """Fold a record stream into a k-mer table. Raises TableOverflowError if unique
    k-mers exceed cfg.table_capacity (checked host-side)."""
    return SampleTableBuilder(cfg, device).build(packed_batches(records, cfg, region), metrics)


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


def run_trio(
    mom_path: str,
    dad_path: str,
    child_path: str,
    cfg: EngineConfig,
    metrics: Optional[Metrics] = None,
    region: Optional[str] = None,
    device=None,
) -> TrioResult:
    """Full single-device trio workflow. ``device=None`` runs on the card."""
    dev = resolve_device(device)
    m = metrics or Metrics()
    tables = {}
    for name, path in (("mom", mom_path), ("dad", dad_path)):
        if path.lower().endswith(".npz"):
            raise NotImplementedError(
                f"`count` table checkpoints ({path}): {_NOT_YET}, item 7")
        with m.timer(f"build_{name}"):
            tables[name] = build_sample_table(path, cfg, m, region=region, device=dev)
        m.event("table_built", sample=name, unique=int(tables[name].n))

    # child scoring: parent-seeded path (ops/score.py); when the k geometry allows it the
    # final window runs the one-sort fused flush+call (ops/fused.py) — no compaction
    scorer = ScoringTableBuilder(cfg, dev)
    child_batches = packed_batches(child_path, cfg, region)
    if fused_supported(cfg.k):
        with m.timer("build_child"):
            cands, _n_union, child_uniques = scorer.build_call(
                tables["mom"], tables["dad"], child_batches, m
            )
            n = int(cands.n)
    else:
        with m.timer("build_child"):
            score_tab = scorer.build(tables["mom"], tables["dad"], child_batches, m)
        child_uniques = int((score_tab.counts >= 1).sum())
        with m.timer("trio_call"):
            cands = call_from_score(score_tab, cfg.tau_parent, cfg.min_child_count)
            n = int(cands.n)
    tables_n = {"mom": int(tables["mom"].n), "dad": int(tables["dad"].n),
                "child": child_uniques}
    m.event("table_built", sample="child", unique=child_uniques)

    def host32(t):
        return t[:n].cpu().numpy().astype(np.uint32)

    keys, cc, mc, dc = (host32(cands.keys), host32(cands.child_counts),
                        host32(cands.mom_counts), host32(cands.dad_counts))
    report = format_report_np(keys, cc, mc, dc, cfg.k)
    cand_tuples = [
        (words_to_kmer_value(keys[i]), int(cc[i]), int(mc[i]), int(dc[i]))
        for i in range(n)
    ]
    m.count("candidates", n)
    return TrioResult(candidates=cand_tuples, report=report, metrics=m, tables_n=tables_n)
