"""End-to-end trio pipeline: BAM/FASTQ streams → parental tables → child scoring → report.

Port of the single-device paths of ``denovo_kmer_tpu/pipeline.py``. ``run_trio``: the host
feeder decodes and 2-bit-packs read batches, the extraction kernel appends each batch's
canonical k-mers to a staging buffer on the device, LSM flushes fold the staging buffer into
sorted count tables, the child is scored against a parent-seeded table and the final window
runs the fused one-sort call; only the candidate set crosses back to the host for the TSV.
``run_trio_multipass`` runs that once per hash pass with the pass filter in the extraction
kernel; ``run_trio_spill`` decodes once, partitions each staging window by pass with the
partition kernel into a device store or host files, and counts each pass from its spill.

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
from denovo_kmer_tpu_torch.ops.partition import MAX_SPILL_BUCKETS
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


def make_ingest_step(cfg: EngineConfig, n_passes: int = 1):
    """The per-batch ingest step of a config: ``append_packed(acc, packed, pass_id=0)``
    extracts a placed batch straight into the staging buffer — length-shipped
    (``vwords is None``) or with its validity words. ``n_passes > 1``: only k-mers whose
    ``router.pass_of`` bucket is ``pass_id`` stay valid (the multipass filter, fused into
    the extraction kernel). The JAX package's ``extractor`` field picks a TPU layout; here
    every value runs the same CUDA kernel."""
    if cfg.read_len_buckets:
        raise NotImplementedError(f"read_len_buckets: {_NOT_YET}, item 8")

    def append_packed(acc, packed: PackedReads, pass_id: int = 0):
        lengths = packed.length if packed.vwords is None else None
        return _extract_append(acc, packed.words, packed.vwords, lengths,
                               cfg.k, cfg.max_read_len, cfg.canonical, n_passes, pass_id)

    return append_packed


def _staging_slots(cfg: EngineConfig) -> int:
    return cfg.accum_batches * cfg.batch_reads * cfg.windows_per_read


class SampleTableBuilder:
    """Streams one sample's packed batches into its k-mer table."""

    def __init__(self, cfg: EngineConfig, device=None, append_packed=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.append_packed = append_packed or make_ingest_step(cfg)

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

    def __init__(self, cfg: EngineConfig, device=None, append_packed=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.append_packed = append_packed or make_ingest_step(cfg)

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
    append_packed=None,
) -> KmerTable:
    """Fold a record stream into a k-mer table. Raises TableOverflowError if unique
    k-mers exceed cfg.table_capacity (checked host-side). ``append_packed`` overrides the
    config's ingest step (a multipass pass's filtered step)."""
    return SampleTableBuilder(cfg, device, append_packed).build(
        packed_batches(records, cfg, region), metrics)


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


def _reject_checkpoints(*paths: str) -> None:
    for path in paths:
        if path.lower().endswith(".npz"):
            raise NotImplementedError(
                f"`count` table checkpoints ({path}): {_NOT_YET}, item 7")


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
    _reject_checkpoints(mom_path, dad_path)
    for name, path in (("mom", mom_path), ("dad", dad_path)):
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


def _candidate_parts(cands: Candidates, n: int):
    """Host uint32 (keys, child, mom, dad) of the first ``n`` candidates."""
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
    keys, cc, mc, dc = keys[order], cc[order], mc[order], dc[order]
    report = format_report_np(keys, cc, mc, dc, cfg.k)
    cand_tuples = [
        (words_to_kmer_value(keys[i]), int(cc[i]), int(mc[i]), int(dc[i]))
        for i in range(keys.shape[0])
    ]
    m.count("candidates", keys.shape[0])
    return TrioResult(candidates=cand_tuples, report=report, metrics=m, tables_n=tables_n)


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
    candidates is exactly the single-pass result. ``device=None`` runs on the card."""
    if n_passes < 2:
        return run_trio(mom_path, dad_path, child_path, cfg, metrics, region, device)
    _reject_checkpoints(mom_path, dad_path)
    dev = resolve_device(device)
    m = metrics or Metrics()
    step = make_ingest_step(cfg, n_passes)
    parts = []
    tables_n = {"mom": 0, "dad": 0, "child": 0}
    for p in range(n_passes):
        def pass_step(acc, packed, _p=p):
            return step(acc, packed, _p)

        ptables = {}
        for name, path in (("mom", mom_path), ("dad", dad_path)):
            with m.timer(f"build_{name}"):
                ptables[name] = build_sample_table(path, cfg, m, region, dev, pass_step)
            tables_n[name] += int(ptables[name].n)
        scorer = ScoringTableBuilder(cfg, dev, pass_step)
        child_batches = packed_batches(child_path, cfg, region)
        with m.timer("build_child"):
            if fused_supported(cfg.k):
                cands, _nu, n_child = scorer.build_call(
                    ptables["mom"], ptables["dad"], child_batches, m)
            else:
                stab = scorer.build(ptables["mom"], ptables["dad"], child_batches, m)
                n_child = int((stab.counts >= 1).sum())
                cands = call_from_score(stab, cfg.tau_parent, cfg.min_child_count)
            n = int(cands.n)
        tables_n["child"] += n_child
        parts.append(_candidate_parts(cands, n))
        m.event("pass_done", pass_id=p, candidates=n)
    return _merge_pass_results(parts, cfg, m, tables_n)


def _spill_stream(path: str, cfg: EngineConfig, n_passes: int, sink, cap: int, m: Metrics,
                  device: torch.device, append_packed, region=None) -> int:
    """Decode and extract ``path`` ONCE, partitioning each full staging window by hash
    pass (``ops/spill.partition_window``) and handing (disp, counts) device tensors to
    ``sink``. Returns the total partition overflow (checked by the caller — loud failure,
    never silent loss)."""
    from denovo_kmer_tpu_torch.ops.spill import partition_window

    slots = _staging_slots(cfg)
    acc = empty_accumulator(slots, cfg.words, device)
    win = cfg.batch_reads * cfg.windows_per_read
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    fill = 0
    feed_stats: dict = {}
    for packed in prefetch_placed(packed_batches(path, cfg, region), device,
                                  ship_lengths=True, stats=feed_stats):
        m.count("reads_ingested", packed.n_reads)
        with m.timer("extract_spill"):
            if fill + win > slots:
                disp, counts, ovf, acc = partition_window(acc, n_passes, cap)
                overflow = overflow + ovf
                sink(disp, counts)
                fill = 0
            acc = append_packed(acc, packed)
            fill += win
        m.count("kmers_extracted", packed.n_reads * cfg.windows_per_read)
        m.count("batches", 1)
    _report_feed_stats(m, feed_stats)
    if fill:
        with m.timer("extract_spill"):
            disp, counts, ovf, acc = partition_window(acc, n_passes, cap)
            overflow = overflow + ovf
            sink(disp, counts)
    return int(overflow)


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
    its own spill.

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
    _reject_checkpoints(mom_path, dad_path)
    append_packed = make_ingest_step(cfg)
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
                                        dev, append_packed, region)
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
                                    append_packed, region)
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
        n = int(table.n)
        if n > C:
            raise TableOverflowError(_overflow_msg(n, C))
        return table, n

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
            n_union = int(stab.n)
            if n_union > C:
                raise TableOverflowError(_overflow_msg(n_union, C))
            tables_n["child"] += int((stab.counts >= 1).sum())
            cands = call_from_score(stab, cfg.tau_parent, cfg.min_child_count)
            n = int(cands.n)
            parts.append(_candidate_parts(cands, n))
        m.event("pass_done", pass_id=p, candidates=n)
    return _merge_pass_results(parts, cfg, m, tables_n)
