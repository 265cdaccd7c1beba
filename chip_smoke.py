#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (denovo_kmer_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with an NVIDIA card (sm_90a, nvcc under
/usr/local/cuda or $CUDA_HOME) and g++ with zlib. It starts six worker processes (phase
8's CRAM and sorted-BAM writers), one a CPU core (phases 12's and 13's references), an HTTP
server thread on 127.0.0.1 and three pairs of
spawned ranks (phase 10, a gloo process group on 127.0.0.1), and stops them all. It exits
non-zero, printing no result, without a card or without the package beside it. Phases,
each printed as one JSON line:

1. build    — compile every CUDA kernel from denovo_kmer_tpu_torch/csrc, one nvcc a source,
              all started together; then the port's native library (the C++ BAM feeder
              and the CRAM codecs; g++, zlib), which must build.
2. kernels  — each kernel against its plain PyTorch version on the card (tolerance 0: every
              quantity is an integer), timed by CUDA events (median after warm-up) beside
              its bound and, where one PyTorch call computes the same function, that call:
              extraction at the main-path batch (B=16384, max_read_len=160) over k in
              {15,21,31,32,33,41,63}, canonical on/off, vwords and length-shipped feeds, with
              the multipass filter (k=31, n_passes=3, pass_id 0 and 2), and at the bucket
              widths 64 and 112 (k=31), each timed with `fill` advancing batch by batch
              through the main path's 34,078,720-row staging window, as the pipeline
              writes, beside the store floor (one launch writing as many bytes, advancing
              the same way); then edge cases: fills 0, 1, 3 and 5 into a buffer whose other
              rows hold a sentinel, 1 and 17 reads, k in {1,15,16,31,32,33,47,48,63},
              widths 32 to 160 (16 and 32 lanes a read) and 600 (several chunks a read),
              both feeds: valid masks identical,
              keys bit-exact where valid and the sentinel rows intact; the partition at
              the spill window (N=34,078,720 rows of 2 words, 5 buckets through the spill's
              entry, 8 through the JAX-contract entry) and at
              benchmarks/micro_radix_partition.py's shape (N=2^24, C=4, 16 buckets), beside
              ops/spill.py:partition_window timed whole at the spill window; then edge
              cases: N below one block and 3 blocks + 1 row, 1, 2, 5, 33 and 1024 buckets,
              random ids, all in one bucket, ids past the last bucket, 1, 2, 4, 5 and 8
              columns, the strided (N, C).T view and a contiguous (C, N) input, and blocks
              of 2^17 rows whose ids do not fit shared memory: rows and counts
              bit-exact; the block sort at every block height it has an instance for
              (2 to 16,384) x {1, 3, 9, 128} columns x keys over the full range, from a
              small range (ties) and >= 2^31, then at benchmarks/micro_pallas_sort.py's
              shape (2^22 x 128, 2048-row blocks): keys and payloads bit-exact, beside
              its torch.sort yardstick, a copy floor, and its registers, spilled bytes
              and resident CTAs an SM at every height from 2,048 up; the table merge
              (csrc/table_merge.cu) at W = 1..4 with one and two weight columns, at 1,000
              and 2^22 rows a side: overlapping sides, each side empty, a union above the
              output's capacity, an n above its side's capacity, the all-ones key last on
              both sides with weights wrapping to 0 (stripped) or not: keys, weights and n
              bit-exact; then at a flush of the call cell (a 2^28-row table of 120M keys,
              80M window keys, 40M shared) beside one torch.sort of the 200M keys. Operations bounds
              divide by the card's integer rate (64 a clock an SM x SMs x the maximum SM
              clock nvidia-smi reads, printed on the start line).
3. parity   — on small synthetic trios, on the card and on the CPU: run_trio at k=31 (the
              fused call) and k=32 (the call_from_score fallback), one batch a window so
              the parents merge into populated tables and the child takes the compacting,
              capacity-growing flush_score; run_trio_spill with a device store (3 passes)
              and run_trio_multipass (2 passes); a length-bucketed run_trio on a
              mixed-length trio, and run_trio fed `count` checkpoints of the parents:
              identical reports. Then the sweep at k in (15, 32, 33), run_cohort of two
              trios with the parental superset, run_evidence to BAM, SAM and FASTQ, and
              group_sites: identical reports, superset rows and file bytes. Then the trio
              as CRAMs (each sample's codec of phase 8, with its FASTA), with a SAM child,
              as sorted BAMs + BAI and CRAMs + CRAI under a region, and over HTTP:
              run_trio on the card and on the CPU gives identical reports, and the
              full-trio ones equal the BAM trio's.
4. main     — run_trio on a 4 Mbp genome with 3 x 262,144 reads of 151 bp, written as BAMs,
              at k=31, batch_reads=16384, accum_batches=16, table_capacity=2^23, decoded by
              the C++ feeder, under a torch.profiler trace of the device (busy time by
              kernel, idle share); the parent tables and the candidates are held against a
              numpy reference computed on the host from the same reads, and every planted
              de novo SNV must lie under a candidate. Then the same call on the pure-Python
              decoder, which must give the same candidates; both runs' feed_wait is printed.
5. multipass — the same BAMs and config: run_trio_spill with 4 passes into a device store
              of 12,000,000 rows a pass; run_trio_spill with 4 passes into a host spill
              directory, then again (it must decode nothing); run_trio_multipass with 2
              passes. Each report must equal phase 4's byte for byte, and the partition
              kernel must launch once a staging window (3 a decoding spill run).
6. checkpoints, buckets — the same BAMs and config: `count` of mom and dad to .npz through
              the CLI (tables equal the numpy reference); a resumable `count` stopped right
              after its first saved cursor and resumed equals the uninterrupted one;
              run_trio with both .npz parents equals phase 4's report; `probe` of 1,000
              k-mers (candidates and random parental k-mers) prints the reference's counts.
              Then a mixed-length trio (the first 65,536 of phase 4's reads a sample, a
              quarter of its depth, trimmed to 60-151 bp): run_trio, and
              with read_len_buckets (64, 112, 160) run_trio, the device-store spill (4
              passes) and the 2-pass re-decode, each equal to the unbucketed run_trio.
7. sweep, cohort, evidence_sites — the same BAMs and config: run_trio_multi_k at k in
              (15, 21, 31, 41), one decode a sample and 4 x 48 extraction launches, k=31's
              report equal to phase 4's, every k's candidates and tables_n to the numpy
              reference at that k and to run_trio at that k (timed beside the sweep), every
              planted SNV under a candidate at every k; `cohort` through the CLI with a
              manifest of phase 4's trio and a trio B sampled from the same genome with its
              own 50 SNVs (96 launches): each trio's TSV equals its run_trio report, the
              parental superset the numpy union of the four parents' counts (a trio B SNV
              under no candidate is printed with its child read depth and the child counts
              of the k-mers over it); `call --evidence-out --sites-out` (16 launches each
              for evidence and sites, counted from 0 around each of their calls):
              the evidence BAM holds exactly the child reads with a valid window whose
              canonical k-mer is a candidate, every planted SNV lies inside a chrS site and
              every site holds one. The extraction's plain version may not run in phase 7.
8. inputs   — phase 4's reads and config: the genome as a FASTA with its .fai; each sample
              as a reference-based CRAM written by the port's writer in coordinate order
              (mom CRAM 3.0 rANS 4x8, dad CRAM 3.1 rANS Nx16, child CRAM 3.1 arith; a worker
              process each, as for each sorted BAM) with its .crai, whose columnar decode must give the reads'
              sequences; coordinate-sorted BAMs with their .bai; the child as SAM. The
              CRAM trio through run_trio (the columnar feeder, pack_chunks x 3, never the
              record loop; 48 launches) and run_trio_spill into a device store (4 passes,
              3 partition launches): phase 4's report. run_trio with --region
              chrS:1000001-3000000 on the BAMs (BAI) and on the CRAMs (CRAI), and `call
              --regions-bed` with two intervals 100 bp apart: candidates and tables_n equal
              the numpy reference over the reads whose span [pos, pos+151) meets the
              region (a read over both intervals once), launches the sum of each sample's
              ceil(reads / 16384). run_trio with the SAM child, and on the three BAMs
              served by a Range-capable HTTP server on 127.0.0.1 (and the region over HTTP
              through the BAI): phase 4's report and the local region report. `call
              --evidence-out --sites-out` on the CRAM trio: phase 4's report, phase 7's
              evidence reads (CRAM names are ordinals in the file), every candidate k-mer
              in exactly one site (a CRAM record has no position, so sites group by the
              read graph). `call --profile-dir` on the BAM trio: a torch.profiler trace
              whose kernel events name extract_kmers. Phase 8 also runs with the
              extraction's plain version refused.

9. sharded — the sharded engine (--mesh) on the one card, each mesh a grid of cuda:0
              repeated (make_mesh with an explicit device list). First, on phase 3's small
              trio, on the card and on the CPU: run_trio_sharded on (1,4), (2,2) and (4,1) at
              k=31 and k=32 against the single-device run_trio, a route-overflow retry
              (factor 0.05, retried until it fits), run_trio_multipass_sharded (2 passes),
              run_trio_spill_sharded (3 passes, device store), run_trio_multi_k_sharded at
              (15, 32, 33) against run_trio_multi_k, run_cohort_sharded of two trios (tuples
              and the superset .npz, its key count run_cohort's) and the sharded probe, both
              plans, against probe_table: everything equal. Then run_trio_sharded at phase
              4's width on a 2x4 mesh (8 shards of 2,048 reads a batch, shard capacity 2^21),
              under a torch.profiler trace: phase 4's report byte for byte, 48 x 8 extraction
              launches, no other kernel; the route, fold, finalize and call seconds
              (synchronized), feed_wait, idle share and peak memory. Through the CLI, `call
              --mesh 2x2` on a host with fewer than 4 cards fails with the JAX package's
              "needs 4 devices" message, and `call --mesh 1x1` gives phase 4's report.
              Phase 2 also times the extraction at the 2x4 mesh's launch (2,048 reads, the
              fill advancing through one shard's staging window).

10. multihost, table_tools — parallel/multihost.run_trio_multihost in 2 spawned processes,
              a gloo process group named explicitly (NCCL refuses two ranks on one GPU),
              each rank on four copies of cuda:0, at phase 4's config on a quarter of its
              depth (the first 65,536 reads of each sample, written as BAMs of their own,
              with their own numpy reference; the whole depth took ~145 s): (a) a 2x4
              mesh with the stripe feed (the reads axis spans the ranks, the table axis
              stays inside each), rank 0 under a torch.profiler trace; (b) the range feed;
              (c) a (1,8) mesh whose route all_to_all crosses the ranks: it warns, and
              require_ici_local=True refuses it; (d) 2 re-decode passes, and 2 passes
              through a per-shard device store of 3,000,000 rows a pass (phase 5's 48,000,000
              store rows over 2 passes and 8 shards); (e) rank 1 killed after 2 child
              batches with a checkpoint directory: rank 1 exits 17, the survivor non-zero
              within the group's 60 s timeout, and a relaunch loads both parents' npz
              checkpoints and builds only the child. Every report on every rank equals
              the reference's; each rank launches the extraction 4 batches x 3 samples x 4
              local shards a trio (twice that for the 2 re-decode passes, the child's 16
              after the restart); each rank's wall, feed wait, route/fold/finalize/call
              seconds and peak device bytes. Every launch runs under one deadline that kills
              every rank when it passes; a rank's failure fails the phase. Then `merge` of
              phase 6's
              two `count` checkpoints on the card, `stats`, `histo` and `dump` of the merged
              table (each equal to the numpy union of the two tables), and `doctor --mesh
              1x1 --probe-feed` on phase 4's child BAM. Phase 4 also prints the card's k-mer
              demand (windows / device-busy seconds), the figure behind the CLI's
              `doctor --probe-feed` default.

11. library — the JAX package's library calls at phase 4's BAMs and config:
              ops/extract_fast.extract_canonical_kmers_fast on one child batch (16,384
              reads, with Ns) at k=31 and k=41 and not canonical, one extraction launch a
              call, valid masks equal to the plain version's and keys equal where valid
              (keys of invalid windows are unspecified: how many differ is printed), each
              call timed beside the plain version; build_sample_table(mom, step=
              SampleTableBuilder(cfg)) equal to the numpy reference; ScoringTableBuilder.build
              (the compacting child build) and call_from_score: phase 4's candidates; on the
              final window of the child's fused lane with max_candidates=1,
              fused_flush_call + extract_candidates raises CandidateOverflowError,
              fused_call_candidates gives phase 4's candidates and unpack_fused the compacting
              build's n_unique and n_child_unique; ingest_batch and merge_score_tables (at the
              table capacity, and overflowing) equal on the card and on the CPU; empty_table,
              table_from_numpy, empty_score_table, score_table_from_numpy,
              empty_accumulator and empty_pass_store without a device allocate on the card.

12. scale   — the main path at a real size: a chr20-length trio (64,444,167 bp, uniform
              random; two haplotypes a parent with substitution SNVs at 1e-3 each; the child
              mom's haplotype 0 with 100 de novo SNVs and dad's haplotype 0), 30x: 12,803,477
              reads of 151 bp a sample, each from one of its sample's haplotypes, half
              reverse strand, with substitution errors and Ns at 1e-3 a base. The reads are
              made in chunks on a spawn pool of one worker a CPU core, each chunk from its
              own seed, and written as BAMs (one reference chr20) by a vectorized
              fixed-layout record writer with BGZF compression in the workers (2.5 GB of
              BAMs under the work directory). The same workers build an independent numpy
              reference: each chunk's canonical k-mers split into 64 hash buckets in a
              shared-memory buffer a sample (3 x 12.4 GB of host memory at the peak, about
              1 GB more a worker), then np.unique with counts a bucket, and the child's
              candidates a bucket. About 3.5 minutes on the H100's 8-core host, 2.5 of them
              the data and reference. Then
              `call` through the CLI on the card: (a) single-pass at --table-capacity 2^28
              with --accum-batches auto, under a torch.profiler trace, and (b) the 4-pass
              device-store spill (--spill-rows 1.10 x the largest sample's valid windows / 4)
              at 2^26. (a)'s report must equal the reference's candidates row for row and
              its tables_n the reference's unique counts, every planted de novo SNV must lie
              under a candidate unless the reference shows each k-mer over it seen fewer than
              twice in the child or seen in a parent (a parent's read with the de novo base
              by a sequencing error hides a site at tau_parent 0; such sites are printed
              with their counts), and (b)'s report must equal (a)'s; each run must launch the
              extraction once a batch (2,346) and the partition once a staging window in (b)
              only, and no flush, seed or fused call may hold more device bytes a row than
              the CLI's auto model counts for its W (cli.STEP_BYTES_PER_ROW). Each run
              prints its wall, Metrics split, feed_wait, peak device bytes, the window auto
              chose, and each table step's calls and device seconds (CUDA events); (a) also
              its busy time, idle share and time by kernel. The BAMs stay for phase 13.
13. sweep_scale — BASELINE config 4 at a real size on phase 12's BAMs. The numpy reference
              at k = 15, 21 and 41 from the same seeded reads (no BAMs written), one k at a
              time, with at most as many samples' shared buffers as fit 60% of the host's
              available memory (k = 41: 22.9 GB a sample); it prints the host's RAM and
              fails before a k starts if one buffer does not fit. Then `sweep --ks
              15,21,31,41 --table-capacity 2^28 --accum-batches auto` through the CLI on the
              card, traced. Each k's report must equal the reference's candidates at that k
              (k = 31's also phase 12 run (a)'s) and its tables_n the reference's unique
              counts, the extraction must launch once a batch a k (4 x 2,346), no table step
              may pass the model's bytes a row for its step and W, and the peak may not pass
              cli.window_peak. It prints each k's candidates and uniques, the auto plan,
              wall, feed_wait, busy time, idle share, the table steps' device seconds by
              step and by k, the peak against the card, and the extraction's launches and
              seconds.

BAMs store reverse-strand reads in reference orientation at the position of their first
stored base, as an aligner does; canonical counting does not see the strand. Each path of
phases 4 to 13 runs with every kernel's launch count set to 0 just before it and read just
after; the counts come from those runs alone (the block sort is a probe that no path
launches). Then a ``kernels`` line (one entry per kernel), the card's name and
power limit as nvidia-smi gives them, and last ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import concurrent.futures
import dataclasses
import functools
import http.server
import io
import json
import multiprocessing
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

if __name__ != "__mp_main__":  # a spawn worker of the host's pools runs numpy alone; a
    import torch               # phase-10 rank imports torch itself (_multihost_worker)

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ["extract_kmers", "radix_partition", "block_sort", "table_merge"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# 32-bit integer add, compare and min/max results a clock an SM at compute capability 9.0
# (CUDA C++ Programming Guide, throughput of native arithmetic instructions)
INT_RESULTS_PER_CLOCK_SM = 64


T0 = time.perf_counter()  # the script's start: each phase line says when it ended


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def power_line() -> str:
    return nvidia_smi("name,power.limit")


@functools.lru_cache(maxsize=None)
def max_sm_clock_mhz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0])


def int_ops_per_s() -> float:
    """The card's integer rate: INT_RESULTS_PER_CLOCK_SM x its SMs x its maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT_RESULTS_PER_CLOCK_SM * sms * max_sm_clock_mhz() * 1e6


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and operations over
    the integer rate."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s() * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call: the stream is first held by a sleep kernel
    so every launch is queued before the timed ones start, and the host's launch overhead
    does not show up as idle device time between events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ---------------------------------------------------------------------------------------
# phase 2: extraction kernel against its plain version
# ---------------------------------------------------------------------------------------

def make_batch(rng, B, max_len, n_rate):
    from denovo_kmer_tpu_torch.ops.pack import _pack_codes, padded_length

    Lp = padded_length(max_len)
    codes = rng.integers(0, 4, size=(B, Lp), dtype=np.uint8)
    lengths = rng.integers(max_len // 3, max_len + 1, size=B).astype(np.int32)
    lengths[: B // 4] = min(READ_LEN, max_len)  # the main path's read length
    lengths[-64:] = 0  # padding rows of a partial batch
    pos = np.arange(Lp)[None, :]
    valid = (pos < lengths[:, None]) & (rng.random((B, Lp)) >= n_rate)
    codes = np.where(valid, codes, 0).astype(np.uint8)
    return _pack_codes(codes, valid, lengths, B - 64)


def extraction_bytes_ops(B, Lw, k, max_len, canonical, with_vwords):
    W = -(-2 * k // 32)
    P = max_len - k + 1
    nbytes = B * Lw * 4 + (B * (Lw // 2) * 4 if with_vwords else B * 4) + B * P * (4 * W + 1)
    # per window: two-word assembly of forward and reverse complement (~10 ops a word),
    # alignment shifts, the canonical compare and select, the validity test
    per_window = 10 * 2 * W + 3 * W + (3 * W if canonical else 0) + (
        6 * -(-k // 32) if with_vwords else 1)
    return nbytes, B * P * per_window


SENTINEL = -0x12345679  # staging rows outside a batch's rows hold this; they must survive


def compare_extraction(run, words, vwords, lengths, k, max_len, canonical, n_passes=1,
                       pass_id=0, fill=0):
    """``run`` (the kernel's wrapper, or a callable with its signature) against the plain
    version on one batch appended at row ``fill`` of a buffer of fill + B*P + 7 rows whose
    other rows hold SENTINEL: valid masks identical, keys bit-exact where valid and in every
    row outside the batch. Returns (max_abs_err, valid windows)."""
    from denovo_kmer_tpu_torch.ops.extract import append_plain
    from denovo_kmer_tpu_torch.ops.stream import empty_accumulator

    dev = words.device
    B = words.shape[0]
    W, P = -(-2 * k // 32), max_len - k + 1
    accs = []
    for fn in (run, append_plain):
        acc = empty_accumulator(fill + B * P + 7, W, dev)
        acc.kmers.fill_(SENTINEL)
        acc.valid.fill_(True)
        accs.append(fn(acc._replace(fill=fill), words, vwords, lengths, k, max_len, canonical,
                       n_passes, pass_id))
    got, want = accs
    torch.cuda.synchronize()
    what = f"B={B} k={k} max_read_len={max_len} canonical={canonical} fill={fill} " \
           f"{'vwords' if vwords is not None else 'lengths'} n_passes={n_passes}/{pass_id}"
    if got.fill != want.fill or not torch.equal(got.valid, want.valid):
        raise AssertionError(f"valid masks differ: {what}")
    rows = want.valid.clone()
    rows[:fill] = True
    rows[fill + B * P:] = True
    diff = ((got.kmers.to(torch.int64) & 0xFFFFFFFF)
            - (want.kmers.to(torch.int64) & 0xFFFFFFFF)).abs()[rows]
    err = int(diff.max()) if diff.numel() else 0
    if err != 0:
        raise AssertionError(f"keys differ where valid or outside the batch: {what} "
                             f"max_abs_err={err}")
    return err, int(want.valid[fill:fill + B * P].sum())


class StagingWindow:
    """The main path's staging window (34,078,720 rows), one buffer per key width: timed
    batches are appended at a fill that advances batch by batch through it, as the
    pipeline writes them, so the output does not sit in L2 between launches."""

    def __init__(self, rows, device):
        self.rows, self.device, self.accs = rows, device, {}

    def timed(self, run, args, W, rows_per_batch):
        from denovo_kmer_tpu_torch.ops.stream import empty_accumulator

        if W not in self.accs:
            self.accs = {W: empty_accumulator(self.rows, W, self.device)}
        acc = self.accs[W]
        slots = max(1, self.rows // rows_per_batch)
        step = [0]

        def call():
            run(acc._replace(fill=(step[0] % slots) * rows_per_batch), *args)
            step[0] += 1
        return call


def store_floor(window, W, rows):
    """The store floor of an append of ``rows`` windows: one ``zero_`` launch writing as many
    bytes as the kernel writes (rows x (4W + 1)), at an offset that advances through a
    buffer of the staging window's size as the appends do (a yardstick, timed like the
    kernel; the port never calls it)."""
    per = rows * (4 * W + 1)
    flat = torch.empty(window.rows * (4 * W + 1), dtype=torch.uint8, device=window.device)
    slots = max(1, flat.numel() // per)
    step = [0]

    def call():
        i = step[0] % slots
        flat[i * per:(i + 1) * per].zero_()
        step[0] += 1
    return call


def extraction_edges(rng, dev, runs):
    """Bit-exact edge cases for each of ``runs`` (the kernel's wrapper, or a callable with
    its signature): unaligned fills, 1 and 17 reads, every key width, the bucket widths and
    a width over 512 bases (several chunks a read), both feeds."""
    from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor

    n = 0
    for max_len in (32, 48, 64, 80, 112, 160, 600):
        for feed, rate in (("vwords", 0.01), ("lengths", 0.0)):
            p = make_batch(rng, 17 + 64, max_len, rate)
            words_all = as_int32_tensor(p.words).to(dev)
            for B in (1, 17):
                words = words_all[:B]
                vwords = as_int32_tensor(p.vwords)[:B].to(dev) if feed == "vwords" else None
                lengths = as_int32_tensor(p.length)[:B].to(dev) if feed == "lengths" else None
                for k in (1, 15, 16, 31, 32, 33, 47, 48, 63):
                    if k > max_len:
                        continue
                    for fill in (0, 1, 3, 5):
                        for run in runs:
                            compare_extraction(run, words, vwords, lengths, k, max_len,
                                               True, fill=fill)
                            n += 1
    return n


def phase_kernels(rng):
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor
    from denovo_kmer_tpu_torch.ops.extract import append_plain, extract_append
    from denovo_kmer_tpu_torch.pipeline import _staging_slots

    dev = torch.device("cuda")
    B = 16384
    window = StagingWindow(_staging_slots(EngineConfig(**MAIN_CFG)), dev)
    cases, worst = [], 0

    def one(words, vwords, lengths, k, max_len, canonical, n_passes=1, pass_id=0):
        args = (words, vwords, lengths, k, max_len, canonical, n_passes, pass_id)
        err, n_valid = 0, 0
        for fill in ((0, 1, 3, 5) if (k, max_len, n_passes) == (K, 160, 1) else (0,)):
            err, n_valid = compare_extraction(extract_append, *args, fill=fill)
        W, P = -(-2 * k // 32), max_len - k + 1
        ms = cuda_ms(window.timed(extract_append, args, W, B * P))
        plain_ms = cuda_ms(window.timed(append_plain, args, W, B * P))
        floor_ms = cuda_ms(store_floor(window, W, B * P))
        nbytes, ops = extraction_bytes_ops(B, words.shape[1], k, max_len, canonical,
                                           vwords is not None)
        bound_ms, bound_by = bound(nbytes, ops)
        cases.append(dict(k=k, max_read_len=max_len, canonical=canonical,
                          feed="vwords" if vwords is not None else "lengths",
                          **({"n_passes": n_passes, "pass_id": pass_id} if n_passes > 1
                             else {}),
                          windows=B * P, valid=n_valid, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, store_floor_ms=floor_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops))
        return err

    # the main width over every key width and every k of phase 7's sweep, then the bucket
    # widths of phase 6 at k=31
    for max_len, ks in ((160, tuple(sorted({15, 21, 31, 32, 33, 63, *SWEEP_KS}))),
                        *((w, (K,)) for w in BUCKETS[:-1])):
        batches = {"vwords": make_batch(rng, B, max_len, 0.01),
                   "lengths": make_batch(rng, B, max_len, 0.0)}
        assert not batches["vwords"].prefix_valid and batches["lengths"].prefix_valid
        for feed, p in batches.items():
            words = as_int32_tensor(p.words).to(dev)
            vwords = as_int32_tensor(p.vwords).to(dev) if feed == "vwords" else None
            lengths = as_int32_tensor(p.length).to(dev) if feed == "lengths" else None
            for k in ks:
                for canonical in (True, False):
                    worst = max(worst, one(words, vwords, lengths, k, max_len, canonical))
            if max_len != 160:
                continue
            for pass_id in (0, 2):  # the multipass filter: k=31, 3 passes
                worst = max(worst, one(words, vwords, lengths, K, max_len, True, 3, pass_id))
    window.accs.clear()
    edges = extraction_edges(rng, dev, [extract_append])
    emit({"phase": "kernels", "kernel": "extract_kmers", "B": B,
          "staging_rows": window.rows, "edge_cases": edges, "cases": cases})

    # phase 9's launch: batch_reads / (R*T) reads of one shard, the fill advancing through
    # one shard's staging window
    shard_reads = B // (MESH[0] * MESH[1])
    p = make_batch(rng, shard_reads, 160, 0.0)
    words = as_int32_tensor(p.words).to(dev)
    lengths = as_int32_tensor(p.length).to(dev)
    args = (words, None, lengths, K, 160, True, 1, 0)
    P = 160 - K + 1
    err, n_valid = compare_extraction(extract_append, *args[:6], fill=3)
    shard_window = StagingWindow(MAIN_CFG["accum_batches"] * shard_reads * P, dev)
    nbytes, ops = extraction_bytes_ops(shard_reads, words.shape[1], K, 160, True, False)
    bound_ms, bound_by = bound(nbytes, ops)
    shard_case = dict(k=K, max_read_len=160, canonical=True, feed="lengths", B=shard_reads,
                      staging_rows=shard_window.rows, windows=shard_reads * P, valid=n_valid,
                      max_abs_err=err,
                      ms=cuda_ms(shard_window.timed(extract_append, args, 2, shard_reads * P)),
                      plain_ms=cuda_ms(shard_window.timed(append_plain, args, 2,
                                                          shard_reads * P)),
                      store_floor_ms=cuda_ms(store_floor(shard_window, 2, shard_reads * P)),
                      bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)
    shard_window.accs.clear()
    emit({"phase": "kernels", "kernel": "extract_kmers", "sharded_launch": shard_case})
    return cases, max(worst, err), shard_case


def partition_library(data, ids, n_buckets, block_lanes):
    """One PyTorch call for the same function: a stable sort by (block, bucket), then the
    row gather (the yardstick; the port never calls it)."""
    N = ids.shape[0]
    block = torch.arange(N, device=ids.device) // block_lanes
    order = torch.sort(block * n_buckets + ids, stable=True).indices
    return data[:, order]


def compare_partition(run, data, ids, nb, block_lanes, what):
    """``run`` against the plain version: rows and counts bit-exact. Returns max_abs_err."""
    from denovo_kmer_tpu_torch.ops.partition import partition_blocks_plain

    out, counts = run(data, ids, nb, block_lanes)
    want, want_counts = partition_blocks_plain(data, ids, nb, block_lanes)
    torch.cuda.synchronize()
    err = max(int(((out.to(torch.int64) & 0xFFFFFFFF)
                   - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max()),
              int((counts - want_counts).abs().max()))
    if err != 0 or int(counts.sum()) != data.shape[1]:
        raise AssertionError(f"partition differs from its plain version: {what} "
                             f"max_abs_err={err}")
    return err


def partition_edges(dev, runs):
    """Bit-exact edge cases for each of ``runs`` (the kernel's entry, or a callable with its
    signature): at 32,768-row blocks, N below one block and 3 blocks + 1 row; 1, 2, 5, 33
    and 1024 buckets (ballot and match ranks); random ids, all ids in one bucket, ids past
    the last bucket; 1, 2, 4, 5 and 8 columns (more than 4 pass through the kernel's tile 4
    at a time); the strided (N, C).T view and a contiguous (C, N) input. Then blocks of 2^17
    rows, whose ids do not fit shared memory, over 2 blocks + 5 rows."""
    from denovo_kmer_tpu_torch.ops.spill import SPILL_BLOCK_LANES

    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = [(N, SPILL_BLOCK_LANES, nb, C) for N in (1000, 3 * SPILL_BLOCK_LANES + 1)
              for nb in (1, 2, 5, 33, 1024) for C in (1, 2, 4, 5, 8)]
    shapes += [(2 * (1 << 17) + 5, 1 << 17, nb, C) for nb in (1, 5, 33, 1024)
               for C in (1, 2, 4, 5)]
    n = 0
    for N, lanes, nb, C in shapes:
        ids_cases = {
            "random": torch.randint(0, nb, (N,), device=dev, generator=gen),
            "one bucket": torch.full((N,), nb // 2, device=dev),
            "past the last": torch.randint(0, nb + 7, (N,), device=dev, generator=gen)}
        rows = torch.randint(-2**31, 2**31, (N, C), dtype=torch.int32, device=dev,
                             generator=gen)
        for layout, data in (("rows.T", rows.T), ("(C, N)", rows.T.contiguous())):
            for name, ids in ids_cases.items():
                for run in runs:
                    compare_partition(run, data, ids.to(torch.int32), nb, lanes,
                                      f"N={N} block_lanes={lanes} C={C} n_buckets={nb} "
                                      f"{layout} {name}")
                    n += 1
    return n


def phase_partition():
    from denovo_kmer_tpu_torch.ops.partition import (
        partition_blocks_plain,
        partition_kernel,
        partition_spill_blocks,
        radix_partition_blocks,
    )
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.ops.spill import (
        SPILL_BLOCK_LANES,
        _window_ids,
        partition_window,
        spill_capacity,
    )
    from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator
    from denovo_kmer_tpu_torch.pipeline import _staging_slots

    S = _staging_slots(EngineConfig(**MAIN_CFG))  # phase 5's staging window, 34,078,720
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    edges = partition_edges(dev, [partition_spill_blocks])

    def rand_words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    cases = []
    # the spill window: staging rows (S, 2), their pass ids over 4 passes with 15% of the
    # rows invalid (bucket 4), passed as the (2, S) view the spill passes
    rows = rand_words(S, 2)
    valid = torch.rand(S, device=dev, generator=gen) >= 0.15
    window = KmerAccumulator(rows, valid, S)
    ids5 = _window_ids(window, SPILL_PASSES)
    ids8 = torch.randint(0, 8, (S,), dtype=torch.int32, device=dev, generator=gen)
    micro = rand_words(4, 1 << 24)
    ids16 = torch.randint(0, 16, (1 << 24,), dtype=torch.int32, device=dev, generator=gen)
    shapes = [
        ("spill window, spill entry", partition_spill_blocks, rows.T, ids5, 5),
        ("spill window, JAX-contract entry", radix_partition_blocks, rows.T, ids8, 8),
        ("micro_radix_partition", radix_partition_blocks, micro, ids16, 16),
    ]
    for name, entry, data, ids, nb in shapes:
        C, N = data.shape
        err = compare_partition(entry, data, ids, nb, SPILL_BLOCK_LANES, name)
        ms = cuda_ms(lambda: entry(data, ids, nb, SPILL_BLOCK_LANES), reps=10)
        plain_ms = cuda_ms(lambda: partition_blocks_plain(data, ids, nb, SPILL_BLOCK_LANES),
                           reps=5)
        library_ms = cuda_ms(lambda: partition_library(data, ids, nb, SPILL_BLOCK_LANES),
                             reps=5)
        nbytes = N * (8 * C + 4)  # rows read and written once, ids read once
        ops = N * 24  # ~24 integer ops a row: ranks, counts, slots, addresses
        bound_ms, bound_by = bound(nbytes, ops)
        cases.append(dict(shape=name, N=N, C=C, n_buckets=nb, block_lanes=SPILL_BLOCK_LANES,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops))
    # the spill's whole partition step at the window: pass ids, the kernel, assemble_blocks
    cap = spill_capacity(S, SPILL_PASSES, 1.4)
    step_ms = cuda_ms(lambda: partition_window(window, SPILL_PASSES, cap), reps=5)
    ids_ms = cuda_ms(lambda: _window_ids(window, SPILL_PASSES), reps=5)
    cases[0].update(partition_window_ms=step_ms, window_ids_ms=ids_ms,
                    kernel_share_of_step=cases[0]["ms"] / step_ms)
    del rows, valid, window, ids5, ids8, micro, ids16
    partition_kernel.launches = 0  # the comparisons above do not count
    emit({"phase": "kernels", "kernel": "radix_partition", "edge_cases": edges,
          "cases": cases})
    return cases


BLOCK_SORT_SHAPE = (1 << 22, 128)  # benchmarks/micro_pallas_sort.py: BLOCKS * R rows, 128 lanes
BLOCK_SORT_R = 2048  # its MICRO_R


def block_sort_library(keys, pays, R):
    """One PyTorch call for the same function (the yardstick; the port never calls it): a
    sort along each block's rows, then the payload gather. Its order of equal keys is not
    the network's, so it is timed, not compared bit for bit."""
    L = keys.shape[1]
    s = torch.sort(keys.view(-1, R, L) ^ -(1 << 31), dim=1)
    return ((s.values ^ -(1 << 31)).view(-1, L),
            torch.take_along_dim(pays.view(-1, R, L), s.indices, dim=1).view(-1, L))


BLOCK_SORT_EDGE_ROWS = tuple(1 << i for i in range(1, 15))  # every instance: 2 .. 16384
BLOCK_SORT_EDGE_COLS = (1, 3, 9, 128)
BLOCK_SORT_EDGE_KEYS = (("full", 0, 2**32), ("ties", 0, 8), ("high", 2**31, 2**32))


def compare_block_sort(run, keys, pays, R, what):
    """``run`` (the kernel's wrapper, or a callable with its signature) against the plain
    version: keys and payloads bit-exact, every column ascending. Returns max_abs_err."""
    from denovo_kmer_tpu_torch.ops.block_sort import block_sort_plain

    got = run(keys, pays, R)
    want = block_sort_plain(keys, pays, R)
    torch.cuda.synchronize()
    err = max(int(((g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF))
                  .abs().max()) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"block sort differs from its plain version: {what} "
                             f"max_abs_err={err}")
    k = got[0].view(-1, R, keys.shape[1]).to(torch.int64) & 0xFFFFFFFF
    if not bool((k[:, 1:] >= k[:, :-1]).all()):
        raise AssertionError(f"block sort output does not ascend: {what}")
    return err


def block_sort_edges(dev, runs):
    """Bit-exact edge cases for each of ``runs``: every block height the kernel has an
    instance for (2 to 16,384) x 1, 3, 9 and 128 columns x keys over the whole range,
    from a small range (ties) and >= 2^31, at least 4 blocks and 4,096 rows. Returns
    (cases, max_abs_err)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    n, worst = 0, 0
    for R in BLOCK_SORT_EDGE_ROWS:
        N = R * max(4, 4096 // R)
        for L in BLOCK_SORT_EDGE_COLS:
            for name, lo, hi in BLOCK_SORT_EDGE_KEYS:
                keys = torch.randint(lo, hi, (N, L), dtype=torch.int64, device=dev,
                                     generator=gen).to(torch.int32)
                pays = torch.arange(N * L, dtype=torch.int32, device=dev).view(N, L)
                for run in runs:
                    worst = max(worst, compare_block_sort(run, keys, pays, R,
                                                          f"R={R} L={L} {name}"))
                    n += 1
    return n, worst


def phase_block_sort():
    """The block-sort kernel against its plain version, bit for bit (keys and payloads), at
    the edge cases of ``block_sort_edges``, then at the Pallas probe's shape, where kernel,
    plain version, the torch.sort yardstick and the copy floor (``copy_`` of keys and of
    payloads: the same bytes) are timed beside the bound; with the kernel's registers and
    resident CTAs an SM."""
    from denovo_kmer_tpu_torch.ops.block_sort import (
        block_sort,
        block_sort_plain,
        kernel_resources,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    edges, edge_err = block_sort_edges(dev, [block_sort])
    N, L = BLOCK_SORT_SHAPE
    R = BLOCK_SORT_R
    keys = torch.randint(-2**31, 2**31, (N, L), dtype=torch.int32, device=dev, generator=gen)
    pays = torch.randint(-2**31, 2**31, (N, L), dtype=torch.int32, device=dev, generator=gen)
    err = compare_block_sort(block_sort, keys, pays, R, "the probe's shape")
    ms = cuda_ms(lambda: block_sort(keys, pays, R), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: block_sort_plain(keys, pays, R), reps=2, warmup=1)
    library_ms = cuda_ms(lambda: block_sort_library(keys, pays, R), reps=5, warmup=1)
    out_k, out_p = torch.empty_like(keys), torch.empty_like(pays)
    copy_ms = cuda_ms(lambda: (out_k.copy_(keys), out_p.copy_(pays)), reps=5, warmup=1)
    block_sort.launches = 0  # the comparisons above do not count
    nbytes = 4 * keys.numel() * 4  # keys and payloads read once and written once
    stages = R.bit_length() - 1
    stages = stages * (stages + 1) // 2
    # a compare (the direction folded in) and four selects a pair and stage
    ops = (N // 2) * L * stages * 5
    bound_ms, bound_by = bound(nbytes, ops)
    out = {"phase": "kernels", "kernel": "block_sort", "shape": [N, L], "block_rows": R,
           "resources": kernel_resources(keys, R),
           "resources_by_height": {r: kernel_resources(keys, r) for r in (4096, 8192, 16384)},
           "stages": stages, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "copy_floor_ms": copy_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops, "edge_cases": edges,
           "edge_max_abs_err": edge_err}
    del keys, pays, out_k, out_p
    torch.cuda.empty_cache()
    emit(out)
    return out


#: rows a side of the merge kernel's edge cases; the call cell's shape for its timing:
#: a table of 2^28 rows holding about 120M k-mers and a window reduced to about 80M unique
#: k-mers, half of them already in the table
TABLE_MERGE_EDGE_ROWS = (1000, 1 << 22)
TABLE_MERGE_SHAPE = {"capacity": 1 << 28, "table_n": 120_000_000, "window_n": 80_000_000,
                     "shared": 40_000_000}


def merge_words(vals, W):
    """(n, W) int32 key words of 24-bit ``vals`` in the values' order: the bits cut into W
    chunks, most significant first, each word's bit 31 set with its chunk's top bit (words
    at or above 2^31 occur and order unsigned)."""
    size = 24 // W
    words = []
    for w in range(W):
        chunk = (vals >> (size * (W - 1 - w))) & ((1 << size) - 1)
        words.append(chunk | ((chunk >> (size - 1)) << 31))
    return (torch.stack(words, 1) & 0xFFFFFFFF).to(torch.int32)


def merge_side(gen, dev, cap, n, W, nc, zero_col):
    """One side of ``merge_rows``: about ``n`` sorted unique keys of 24-bit values at
    random (so two sides overlap), padded to ``cap`` rows, with ``nc`` weight columns of
    random bits, the first a column of zeros (None) with ``zero_col``."""
    vals = torch.unique(torch.randint(0, 1 << 24, (n,), generator=gen, device=dev))[:cap]
    m = vals.shape[0]
    keys = torch.full((cap, W), -1, dtype=torch.int32, device=dev)
    keys[:m] = merge_words(vals, W)
    cols = [None] if zero_col else []
    while len(cols) < nc:
        col = torch.zeros((cap,), dtype=torch.int32, device=dev)
        col[:m] = torch.randint(-2**31, 2**31, (m,), generator=gen, device=dev)
        cols.append(col)
    return keys, torch.tensor(m, device=dev), cols


def table_merge_cases(dev, W, nc, rows):
    """[(name, merge_rows arguments)] at about ``rows`` rows a side: overlapping sides,
    each side empty, a union above the output's capacity, a side whose ``n`` is above its
    capacity (an overflowed table: every row real), and the all-ones key last on both
    sides, its weights summing to 0 (the row is stripped) or not."""
    gen = torch.Generator(device=dev).manual_seed(10 * W + nc)
    ka, na, ca = merge_side(gen, dev, rows, rows // 2, W, nc, False)
    kb, nb, cb = merge_side(gen, dev, rows // 2 + 3, rows // 3, W, nc, nc == 2)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    m = int(na)
    full = (ka[:m].clone(), torch.tensor(m + 5, device=dev),
            [None if c is None else c[:m].clone() for c in ca])
    cases = [("overlap", (ka, na, ca, kb, nb, cb, 2 * rows)),
             ("empty_b", (ka, na, ca, kb, zero, cb, rows)),
             ("empty_a", (ka, zero, ca, kb, nb, cb, rows)),
             ("both_empty", (ka, zero, ca, kb, zero, cb, 64)),
             ("above_capacity", (ka, na, ca, kb, nb, cb, m // 2 + 1)),
             ("n_above_cap", (*full, kb, nb, cb, rows))]
    for name, wa, wb in (("all_ones_wraps_to_0", 7, -7), ("all_ones_kept", 5, 1)):
        ka2, kb2 = ka.clone(), kb.clone()
        ka2[m - 1] = -1
        kb2[int(nb) - 1] = -1
        ca2 = [None if c is None else c.clone() for c in ca]
        cb2 = [None if c is None else c.clone() for c in cb]
        for c2a, c2b in zip(ca2, cb2):
            if c2b is None:
                c2a[m - 1] = 0 if wa + wb == 0 else wa
            else:
                c2a[m - 1], c2b[int(nb) - 1] = wa, wb  # 7 + (2^32 - 7) wraps to 0
        cases.append((name, (ka2, na, ca2, kb2, nb, cb2, rows)))
    return cases


def compare_table_merge(run, args, what):
    """``run(*args)`` against ``merge_rows_plain(*args)``: keys, weights, n and the rows
    read, bit for bit."""
    from denovo_kmer_tpu_torch.ops.table_merge import merge_rows_plain

    got = run(*args)
    want = merge_rows_plain(*args)
    same = (torch.equal(got[0], want[0]) and len(got[1]) == len(want[1])
            and all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
            and int(got[2]) == int(want[2]) and int(got[3]) == int(want[3]))
    if not same:
        raise AssertionError(f"table merge differs from its plain version: {what}")


def table_merge_edges(dev, runs, rows=TABLE_MERGE_EDGE_ROWS):
    """Each of ``runs`` (callables with ``merge_rows``' signature) against the plain
    version at W = 1..4, one and two weight columns and each of ``table_merge_cases`` at
    every size of ``rows``. Returns the number of comparisons."""
    n = 0
    for W in (1, 2, 3, 4):
        for nc in (1, 2):
            for r in rows:
                for name, args in table_merge_cases(dev, W, nc, r):
                    for run in runs:
                        compare_table_merge(run, args, f"W={W} cols={nc} rows={r} {name}")
                        n += 1
    return n


def table_merge_shape(dev, shape=TABLE_MERGE_SHAPE):
    """The merge at a flush of the call cell (W = 2, one weight column): a table of
    ``capacity`` rows holding ``table_n`` keys and a window of ``window_n`` unique keys,
    ``shared`` of them in the table; 64-bit random keys."""
    gen = torch.Generator(device=dev).manual_seed(18)
    C, na, nb, shared = (shape[k] for k in ("capacity", "table_n", "window_n", "shared"))
    vals = torch.unique(torch.randint(0, 1 << 62, (na + nb - shared + (1 << 20),),
                                      generator=gen, device=dev))[:na + nb - shared]
    vals = vals[torch.randperm(vals.shape[0], generator=gen, device=dev)]
    a_vals = vals[:na].sort().values
    b_vals = torch.cat([vals[:shared], vals[na:]]).sort().values
    del vals

    def side(v, cap):
        keys = torch.full((cap, 2), -1, dtype=torch.int32, device=dev)
        keys[:v.shape[0], 0] = ((v >> 32) & 0xFFFFFFFF).to(torch.int32)
        keys[:v.shape[0], 1] = (v & 0xFFFFFFFF).to(torch.int32)
        col = torch.zeros((cap,), dtype=torch.int32, device=dev)
        col[:v.shape[0]] = torch.randint(1, 1000, (v.shape[0],), generator=gen, device=dev,
                                         dtype=torch.int32)
        return keys, torch.tensor(v.shape[0], device=dev), [col]

    ka, n_a, ca = side(a_vals, C)
    kb, n_b, cb = side(b_vals, nb)
    return (ka, n_a, ca, kb, n_b, cb, C), (a_vals, b_vals)


def phase_table_merge():
    """The table-merge kernel against its plain version, bit for bit, at the edge cases of
    ``table_merge_edges``, then at a flush of the call cell (``table_merge_shape``), where
    kernel, plain version and the torch.sort yardstick (one sort of the two sides' 64-bit
    keys concatenated) are timed beside the bound: the valid rows of both sides read once
    and the output's valid rows written once, 12 B a row."""
    from denovo_kmer_tpu_torch.ops.table_merge import merge_kernel, merge_rows_plain

    dev = torch.device("cuda")
    edges = table_merge_edges(dev, [merge_kernel])
    args, (a_vals, b_vals) = table_merge_shape(dev)
    compare_table_merge(merge_kernel, args, "the call cell's shape")
    ms = cuda_ms(lambda: merge_kernel(*args), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: merge_rows_plain(*args), reps=2, warmup=1)
    both = torch.cat([a_vals, b_vals])
    library_ms = cuda_ms(lambda: torch.sort(both), reps=5, warmup=1)
    n_out = int(merge_kernel(*args)[2])
    merge_kernel.launches = 0  # the comparisons above do not count
    rows_in = a_vals.shape[0] + b_vals.shape[0]
    nbytes = (rows_in + n_out) * 12
    bound_ms, bound_by = bound(nbytes, 0)
    out = {"phase": "kernels", "kernel": "table_merge", "shape": TABLE_MERGE_SHAPE,
           "n_out": n_out, "edge_cases": edges, "max_abs_err": 0, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes}
    del args, a_vals, b_vals, both
    torch.cuda.empty_cache()
    emit(out)
    return out


# ---------------------------------------------------------------------------------------
# phase 3: run_trio on the card equals run_trio on the CPU
# ---------------------------------------------------------------------------------------

def phase_parity(work):
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
    from denovo_kmer_tpu_torch.pipeline import run_trio, run_trio_multipass, run_trio_spill

    trio = make_trio(TrioSpec(genome_len=20000, seed=0))
    paths = write_trio_bams(trio, os.path.join(work, "small"))
    out = {}
    for k in (31, 32):
        # one batch a window: every sample spans several windows (2,400 reads a sample)
        cfg = EngineConfig(k=k, max_read_len=128, batch_reads=1024, accum_batches=1,
                           table_capacity=1 << 16)
        if not all(len(r) > cfg.batch_reads * cfg.accum_batches for r in trio.reads.values()):
            raise AssertionError("the parity trio must span several flush windows a sample")
        t0 = time.perf_counter()
        gpu = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cuda")
        t1 = time.perf_counter()
        cpu = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cpu")
        t2 = time.perf_counter()
        if (gpu.report, gpu.tables_n, gpu.candidates) != (cpu.report, cpu.tables_n,
                                                          cpu.candidates):
            raise AssertionError(f"run_trio on cuda != run_trio on cpu at k={k}")
        if not gpu.candidates:
            raise AssertionError(f"no candidates at k={k}")
        out[f"k{k}"] = dict(candidates=len(gpu.candidates), tables_n=gpu.tables_n,
                            cuda_s=t1 - t0, cpu_s=t2 - t1)
        if k != 31:
            continue
        # the multipass paths at k=31: a device-store spill of 3 passes (each window of
        # 100,352 rows is three full partition blocks and a ragged one) and 2 re-decode
        # passes; both must give run_trio's report
        call = (paths["mom"], paths["dad"], paths["child"], cfg)
        for name, run in (
                ("spill3", lambda d: run_trio_spill(*call, 3, device_store_rows=1 << 17,
                                                    device=d)),
                ("multipass2", lambda d: run_trio_multipass(*call, 2, device=d))):
            t0 = time.perf_counter()
            gpu_mp = run("cuda")
            t1 = time.perf_counter()
            cpu_mp = run("cpu")
            t2 = time.perf_counter()
            if (gpu_mp.report, gpu_mp.tables_n) != (cpu_mp.report, cpu_mp.tables_n):
                raise AssertionError(f"{name} on cuda != {name} on cpu")
            if gpu_mp.report != gpu.report:
                raise AssertionError(f"{name} report != run_trio report")
            out[f"k31_{name}"] = dict(tables_n=gpu_mp.tables_n, cuda_s=t1 - t0, cpu_s=t2 - t1)
    emit({"phase": "parity", "batch_reads": 1024, "accum_batches": 1,
          "reads": {s: len(r) for s, r in trio.reads.items()}, **out})
    return paths


def phase_parity_buckets(work):
    """cuda == cpu at a small size for a bucketed run_trio on a mixed-length trio (reads of
    60-151 bp) and for run_trio fed `count` checkpoints of the parents; both reports equal
    the plain run_trio's."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import build_sample_table, run_trio
    from denovo_kmer_tpu_torch.utils.checkpoint import save_table

    rng = np.random.default_rng(11)
    paths = write_mixed_trio(rng, os.path.join(work, "small_mixed"), genome_len=20000,
                             n_reads=3000, n_snvs=5)[0]
    plain = EngineConfig(k=K, max_read_len=160, batch_reads=1024, accum_batches=1,
                         table_capacity=1 << 17)
    buck = dataclasses.replace(plain, read_len_buckets=BUCKETS)
    trio = (paths["mom"], paths["dad"], paths["child"])
    want = run_trio(*trio, plain, device="cuda")
    if not want.candidates:
        raise AssertionError("no candidates on the small mixed-length trio")
    npz = {}
    for s_ in ("mom", "dad"):
        npz[s_] = os.path.join(work, "small_mixed", f"{s_}.npz")
        save_table(npz[s_], build_sample_table(paths[s_], plain, device="cuda"), plain,
                   source=paths[s_])
    out = {}
    for name, call, cfg in (("bucketed", trio, buck),
                            ("npz_parents", (npz["mom"], npz["dad"], paths["child"]), plain)):
        t0 = time.perf_counter()
        gpu = run_trio(*call, cfg, device="cuda")
        t1 = time.perf_counter()
        cpu = run_trio(*call, cfg, device="cpu")
        t2 = time.perf_counter()
        if (gpu.report, gpu.tables_n) != (cpu.report, cpu.tables_n):
            raise AssertionError(f"{name} run_trio on cuda != on cpu")
        if (gpu.report, gpu.tables_n) != (want.report, want.tables_n):
            raise AssertionError(f"{name} run_trio != the plain run_trio")
        out[name] = dict(candidates=len(gpu.candidates), cuda_s=t1 - t0, cpu_s=t2 - t1)
    emit({"phase": "parity_buckets_checkpoints", "buckets": list(BUCKETS), **out})


def phase_parity_slice(work, paths):
    """cuda == cpu on phase 3's small trio for the paths of the sweep, the cohort, evidence
    and sites: run_trio_multi_k at (15, 32, 33) (fused and compacting ks in one sweep),
    run_cohort of that trio and a second one with the superset, run_evidence to BAM, SAM
    and FASTQ, and group_sites: identical reports, superset rows and file bytes."""
    from denovo_kmer_tpu_torch.cohort import TrioPaths, run_cohort, run_trio_multi_k
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
    from denovo_kmer_tpu_torch.ops.table import table_to_numpy
    from denovo_kmer_tpu_torch.pipeline import run_evidence, run_trio
    from denovo_kmer_tpu_torch.sites import group_sites, write_sites_tsv

    cfg = EngineConfig(k=K, max_read_len=128, batch_reads=1024, accum_batches=1,
                       table_capacity=1 << 16)
    trio = (paths["mom"], paths["dad"], paths["child"])
    second = write_trio_bams(make_trio(TrioSpec(genome_len=20000, seed=1)),
                             os.path.join(work, "small_b"))
    trios = [TrioPaths("a", *trio), TrioPaths("b", second["mom"], second["dad"],
                                               second["child"])]
    tsv = os.path.join(work, "small", "candidates.tsv")
    with open(tsv, "w") as f:
        f.write(run_trio(*trio, cfg, device="cuda").report)

    def evidence_bytes(dev):
        out = {}
        for ext in ("bam", "sam", "fastq"):
            path = os.path.join(work, "small", f"ev_{dev}.{ext}")
            run_evidence(paths["child"], tsv, cfg, path, device=dev)
            with open(path, "rb") as f:
                out[ext] = f.read()
        return out

    def sites_bytes(dev):
        path = os.path.join(work, "small", f"sites_{dev}.tsv")
        write_sites_tsv(group_sites(paths["child"], tsv, cfg, device=dev), path)
        with open(path) as f:
            return f.read()

    def cohort_rows(dev):
        res, sup = run_cohort(trios, cfg, device=dev)
        keys, counts, n = table_to_numpy(sup)
        return ({name: (r.report, r.tables_n) for name, r in res.items()},
                keys[:n].tobytes(), counts[:n].tobytes())

    runs = {
        "sweep_15_32_33": lambda dev: {k: (r.report, r.tables_n) for k, r in
                                       run_trio_multi_k(*trio, cfg, (15, 32, 33),
                                                        device=dev).items()},
        "cohort": cohort_rows, "evidence": evidence_bytes, "sites": sites_bytes}
    out = {}
    for name, run in runs.items():
        gpu, wall, launches = run_counted(lambda: run("cuda"))
        t0 = time.perf_counter()
        cpu = run("cpu")
        cpu_s = time.perf_counter() - t0
        if gpu != cpu:
            raise AssertionError(f"{name} on cuda != {name} on cpu")
        if launches["extract_kmers"] == 0:
            raise AssertionError(f"{name} launched no extraction on the card")
        if name.startswith("sweep") and not all(r[0].count("\n") > 1 for r in gpu.values()):
            raise AssertionError("a k of the small sweep called no candidate")
        out[name] = {"cuda_s": wall, "cpu_s": cpu_s, "launches": launches["extract_kmers"]}
    emit({"phase": "parity_sweep_cohort_evidence", **out})


# ---------------------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------------------

K = 31
READ_LEN = 151
N_READS = 262_144
GENOME_LEN = 4_000_000
N_SNVS = 50
MAIN_CFG = dict(k=K, max_read_len=160, batch_reads=16384, accum_batches=16,
                table_capacity=1 << 23)
BUCKETS = (64, 112, 160)  # phase 6's read_len_buckets
BUCKET_READS = N_READS // 4  # phase 6's mixed trio: the first quarter of each sample's reads


def sample_reads(rng, genome, n_rate, n=N_READS):
    """n reads of READ_LEN from random positions, half reverse-complemented; codes with 4 = N."""
    pos = rng.integers(0, len(genome) - READ_LEN + 1, size=n)
    codes = genome[pos[:, None] + np.arange(READ_LEN)[None, :]]
    rev = rng.random(n) < 0.5
    codes[rev] = 3 - codes[rev, ::-1]
    if n_rate:
        codes[rng.random(codes.shape) < n_rate] = 4
    return pos, rev, codes


def bam_records(name, codes, pos, rev, lens=None, order=None):
    """One BamRecord a row of ``codes`` (reads as sequenced), in ``order`` (row indices;
    all rows in turn by default), named ``{name}_r{row}``; ``lens`` trims row i to its first
    lens[i] bases. A reverse-strand read is stored as an aligner stores it: in reference
    orientation (the trimmed read reverse-complemented), at the reference position of its
    first stored base."""
    from denovo_kmer_tpu_torch.io.bam import BamRecord

    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    text = alphabet[codes].tobytes().decode()
    # row i reverse-complemented: its trimmed read's reverse complement is the row's last n
    text_rc = alphabet[np.where(codes < 4, 3 - codes, 4)[:, ::-1]].tobytes().decode()
    L = codes.shape[1]
    for i in (range(codes.shape[0]) if order is None else order):
        n = L if lens is None else int(lens[i])
        if rev[i]:
            seq, start = text_rc[i * L + L - n:(i + 1) * L], int(pos[i]) + L - n
        else:
            seq, start = text[i * L:i * L + n], int(pos[i])
        yield BamRecord(name=f"{name}_r{i}", flag=0x10 if rev[i] else 0, refid=0,
                        pos=start, mapq=60, cigar=((n, 0),), seq=seq)


def write_bam(path, name, codes, pos, rev, genome_len, lens=None, order=None):
    """``bam_records`` of the rows written as a BAM on one reference, chrS."""
    from denovo_kmer_tpu_torch.io.bam import BamWriter

    with open(path, "wb") as f, BamWriter(f, references=[("chrS", genome_len)],
                                          level=1) as w:
        for rec in bam_records(name, codes, pos, rev, lens, order):
            w.write(rec)


def write_mixed_trio(rng, outdir, genome=None, child_genome=None, genome_len=None,
                     n_reads=N_READS, n_snvs=0, samples=None):
    """A trio of reads trimmed to 60-151 bp, written as BAMs: from ``samples`` (pos, rev,
    codes) when given, else sampled from ``genome``/``child_genome`` (drawn with ``n_snvs``
    child SNVs when not given). Returns (paths, total bases)."""
    os.makedirs(outdir, exist_ok=True)
    if samples is None:
        if genome is None:
            genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
            child_genome = genome.copy()
            snvs = rng.choice(np.arange(200, genome_len - 200), n_snvs, replace=False)
            child_genome[snvs] = (child_genome[snvs] + rng.integers(1, 4, n_snvs)) % 4
        samples = {"mom": sample_reads(rng, genome, 0.0, n_reads),
                   "dad": sample_reads(rng, genome, 0.0, n_reads),
                   "child": sample_reads(rng, child_genome, 0.001, n_reads)}
    paths, bases = {}, 0
    for name, (pos, rev, codes) in samples.items():
        lens = rng.integers(60, READ_LEN + 1, size=codes.shape[0])
        bases += int(lens.sum())
        paths[name] = os.path.join(outdir, f"{name}.bam")
        write_bam(paths[name], name, codes, pos, rev, GENOME_LEN, lens)
    return paths, bases


@contextlib.contextmanager
def python_feeder():
    """Run the pipeline on the pure-Python BAM decoder: the C++ feeder reports itself
    unavailable for the duration."""
    from denovo_kmer_tpu_torch.io import native

    real = native.native_available
    native.native_available = lambda: False
    try:
        yield
    finally:
        native.native_available = real


def window_words(codes, k):
    """Host numpy: the canonical k-mer of every window of every row of ``codes`` as (hi, lo)
    uint64 (n, P) halves of its 2k-bit value (hi None where k <= 32), and whether the window
    holds no N (n, P) bool. Windows of 2^i bases are built by doubling and joined by the
    bits of k, so the cost grows with log k; 4,096 rows at a time, so the doublings stay in
    cache."""
    parts = [_window_words_rows(codes[a:a + 4096], k) for a in range(0, codes.shape[0], 4096)]
    if not parts:
        parts = [_window_words_rows(codes, k)]
    hi = None if k <= 32 else np.concatenate([p[0] for p in parts])
    return hi, np.concatenate([p[1] for p in parts]), np.concatenate([p[2] for p in parts])


def _window_words_rows(codes, k):
    """``window_words`` of a block of rows."""
    n, L = codes.shape
    P = L - k + 1
    c = np.minimum(codes, 3).astype(np.uint64)
    # fwd[m][:, j]: bases j..j+m-1, first base most significant; rc[m][:, j]: its reverse
    # complement, (3 - base j+i) at bits 2i
    fwd, rc, m = {1: c}, {1: np.uint64(3) - c}, 1
    while 2 * m <= min(k, 32):
        f, r = fwd[m], rc[m]
        fwd[2 * m] = (f[:, :-m] << np.uint64(2 * m)) | f[:, m:]
        rc[2 * m] = r[:, :-m] | (r[:, m:] << np.uint64(2 * m))
        m *= 2

    def window(length, start):
        """(fwd, rc) of the windows of ``length`` <= 32 bases from base ``start`` on, P of
        them."""
        f = r = None
        at = 0
        for p in sorted(fwd, reverse=True):
            if length - at < p:
                continue
            fp = fwd[p][:, start + at:start + at + P]
            rp = rc[p][:, start + at:start + at + P]
            if f is None:
                f, r = fp, rp
            else:
                f = (f << np.uint64(2 * p)) | fp
                r = r | (rp << np.uint64(2 * at))
            at += p
        return f, r

    if k <= 32:
        f, r = window(k, 0)
        hi, lo = None, np.minimum(f, r)
    else:
        fh, rl = window(k - 32, 0)[0], window(32, 0)[1]
        fl, rh = window(32, k - 32)[0], window(k - 32, 32)[1]
        take_rc = (rh < fh) | ((rh == fh) & (rl < fl))
        hi, lo = np.where(take_rc, rh, fh), np.where(take_rc, rl, fl)
    bad = np.concatenate([np.zeros((n, 1), np.int32),
                          np.cumsum(codes == 4, axis=1, dtype=np.int32)], axis=1)
    return hi, lo, (bad[:, k:k + P] - bad[:, :P]) == 0


def window_values(codes, k=K):
    """Host numpy, k <= 32: the canonical k-mer value of every window of every row of
    ``codes`` (n, P) uint64, and whether the window holds no N (n, P) bool."""
    assert k <= 32
    _, lo, valid = window_words(codes, k)
    return lo, valid


def reference_counts(codes, k=K):
    """Host numpy reference: unique canonical k-mers of every valid window (uint64 values
    where k <= 32, else (m, 2) uint64 (hi, lo) rows, ascending), their counts, and the
    number of valid windows."""
    rows = canonical_rows(codes, k)
    if rows.shape[1] == 1:
        keys, counts = sorted_counts(rows[:, 0])
        return keys, counts, rows.shape[0]
    keys, counts = unique_pairs(rows[:, 0], rows[:, 1])
    order = lex_order(keys[:, 0], keys[:, 1])
    return keys[order], counts[order], rows.shape[0]


def sorted_counts(values):
    """The distinct values of the uint64 array ``values`` (sorted in place) ascending, and
    their counts: one value sort, where ``np.unique`` sorts a copy and makes more."""
    values.sort()
    n = values.size
    new = np.ones(n, bool)
    np.not_equal(values[1:], values[:-1], out=new[1:])
    at = np.flatnonzero(new)
    return values[at], np.diff(at, append=n)


def references(jobs, workers=4):
    """``reference_counts`` of every ``{key: (codes, k)}`` of ``jobs``, one spawn worker a job
    on ``workers`` processes (each builds and sorts every window of its rows)."""
    with concurrent.futures.ProcessPoolExecutor(
            min(workers, len(jobs)), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {key: pool.submit(reference_counts, codes, k)
                   for key, (codes, k) in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def _rows_in(a, b):
    """Which rows of ``a`` are rows of ``b`` (each (m, 2), rows unique within each)."""
    both = np.concatenate([a, b])
    order = lex_order(both[:, 0], both[:, 1])
    s = both[order]
    eq = (s[1:] == s[:-1]).all(axis=1)
    dup = np.zeros(s.shape[0], bool)
    dup[1:] |= eq
    dup[:-1] |= eq
    hit = np.empty_like(dup)
    hit[order] = dup
    return hit[:a.shape[0]]


def canonical_of(window_codes):
    v = 0
    r = 0
    for j, c in enumerate(window_codes):
        v = (v << 2) | int(c)
        r |= (3 - int(c)) << (2 * j)
    return min(v, r)


def snvs_missed(candidates, genome, snvs, k=K):
    """Planted SNVs with no candidate among the k-mers over them."""
    found = {v for v, _, _, _ in candidates}
    return [int(p) for p in snvs
            if not any(canonical_of(genome[st:st + k]) in found for st in range(p - k + 1, p + 1))]


def reference_candidates(ref, cfg):
    """The trio call on the host references ({sample: reference_counts(...)}): child k-mers
    with count >= min_child_count absent from both parents, as (value, child, 0, 0)."""
    ck, cc = ref["child"][:2]
    if ck.ndim == 1:
        cand = ((cc >= cfg.min_child_count) & ~np.isin(ck, ref["mom"][0])
                & ~np.isin(ck, ref["dad"][0]))
        return [(int(v), int(c), 0, 0) for v, c in zip(ck[cand], cc[cand])]
    cand = ((cc >= cfg.min_child_count) & ~_rows_in(ck, ref["mom"][0])
            & ~_rows_in(ck, ref["dad"][0]))
    return [((int(h) << 64) | int(v), int(c), 0, 0) for (h, v), c in zip(ck[cand], cc[cand])]


def cli_flags(cfg):
    """The engine flags of ``cfg`` for the CLI, on the card."""
    return ["-k", str(cfg.k), "--max-read-len", str(cfg.max_read_len), "--batch-reads",
            str(cfg.batch_reads), "--table-capacity", str(cfg.table_capacity), "--device",
            "cuda"]


def check_table(table, ref_keys, ref_counts, n_windows, capacity, name):
    from denovo_kmer_tpu_torch.ops.table import table_to_numpy

    keys, counts, n = table_to_numpy(table)
    if n > capacity:
        raise AssertionError(f"{name}: n={n} > capacity {capacity}")
    vals = (keys[:n, 0].astype(np.uint64) << np.uint64(32)) | keys[:n, 1].astype(np.uint64)
    if n > 1 and not (vals[1:] > vals[:-1]).all():
        raise AssertionError(f"{name}: keys not strictly ascending")
    total = int(counts[:n].astype(np.int64).sum())
    if total != n_windows:
        raise AssertionError(f"{name}: sum(counts)={total} != {n_windows} valid windows")
    if not (np.array_equal(vals, ref_keys) and np.array_equal(counts[:n], ref_counts)):
        raise AssertionError(f"{name}: table differs from the numpy reference")
    return n


def phase_main(rng, work):
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.native import NativeBamFeeder
    from denovo_kmer_tpu_torch.pipeline import build_sample_table, run_trio
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    t0 = time.perf_counter()
    genome = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
    child_genome = genome.copy()
    snvs = np.sort(rng.choice(np.arange(1000, GENOME_LEN - 1000), N_SNVS, replace=False))
    child_genome[snvs] = (child_genome[snvs] + rng.integers(1, 4, N_SNVS)) % 4
    samples = {"mom": sample_reads(rng, genome, 0.0),
               "dad": sample_reads(rng, genome, 0.0),
               "child": sample_reads(rng, child_genome, 0.001)}
    t1 = time.perf_counter()
    paths = {}
    for name, (pos, rev, codes) in samples.items():
        paths[name] = os.path.join(work, f"{name}.bam")
        write_bam(paths[name], name, codes, pos, rev, GENOME_LEN)
    t2 = time.perf_counter()

    cfg = EngineConfig(**MAIN_CFG)
    m = Metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        reset_launches()  # count the main path's launches alone
        NativeBamFeeder.batches = 0
        t3 = time.perf_counter()
        res = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, m, device="cuda")
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        launches = read_launches()
        native_batches = NativeBamFeeder.batches
    peak = torch.cuda.max_memory_allocated()
    device = device_time(prof, os.path.join(work, "main_trace.json"), t4 - t3)
    batches = m.counters["batches"]
    if batches != 3 * -(-N_READS // cfg.batch_reads) or launches["extract_kmers"] != batches:
        raise AssertionError(f"extract_kmers launched {launches['extract_kmers']} times "
                             f"for {batches} batches")
    if launches["radix_partition"] != 0:
        raise AssertionError("run_trio launched the partition kernel")
    if native_batches != batches:
        raise AssertionError(f"the C++ feeder returned {native_batches} of run_trio's "
                             f"{batches} batches")

    # checks against the host reference: parent tables, candidates, planted SNVs
    t5 = time.perf_counter()
    ref = references({name: (codes, K) for name, (_, _, codes) in samples.items()})
    for name in ("mom", "dad"):
        table = build_sample_table(paths[name], cfg, device="cuda")
        n = check_table(table, ref[name][0], ref[name][1], ref[name][2],
                        cfg.table_capacity, name)
        if n != res.tables_n[name]:
            raise AssertionError(f"{name}: rebuilt n={n} != run_trio's {res.tables_n[name]}")
    want = reference_candidates(ref, cfg)
    if res.candidates != want:
        raise AssertionError(f"candidates differ from the numpy reference "
                             f"({len(res.candidates)} vs {len(want)})")
    if res.tables_n["child"] != len(ref["child"][0]):
        raise AssertionError(f"child uniques {res.tables_n['child']} != {len(ref['child'][0])}")
    missed = snvs_missed(res.candidates, child_genome, snvs)
    if missed:
        raise AssertionError(f"planted SNVs under no candidate: {missed}")
    t6 = time.perf_counter()

    # the same call on the pure-Python decoder: the same report, the same candidates
    m_py = Metrics()
    with python_feeder():
        reset_launches()
        NativeBamFeeder.batches = 0
        t7 = time.perf_counter()
        res_py = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, m_py, device="cuda")
        torch.cuda.synchronize()
        t8 = time.perf_counter()
        launches_py = read_launches()
        native_batches_py = NativeBamFeeder.batches
    if native_batches_py != 0:
        raise AssertionError(f"the C++ feeder returned {native_batches_py} batches of the "
                             "run on the Python decoder")
    if res_py.report != res.report or res_py.candidates != want:
        raise AssertionError("run_trio on the Python decoder differs from the reference")
    if launches_py["extract_kmers"] != batches:
        raise AssertionError(f"extract_kmers launched {launches_py['extract_kmers']} times "
                             f"for {batches} batches (Python decoder)")

    def stages(mm, wall):
        sec = mm.seconds
        return {"run_trio_s": wall, "build_mom_s": sec["build_mom"],
                "build_dad_s": sec["build_dad"], "build_child_s": sec["build_child"],
                "trio_call_s": sec["trio_call"], "feed_wait_s": sec.get("feed_wait", 0.0),
                "child_kmers_per_s": N_READS * cfg.windows_per_read / sec["build_child"]}

    emit({"phase": "main", "config": MAIN_CFG,
          "reads_per_sample": N_READS, "read_len": READ_LEN, "genome_len": GENOME_LEN,
          "data_s": t1 - t0, "bam_write_s": t2 - t1, "feeder": "native",
          "native_feeder_batches": native_batches, **stages(m, t4 - t3),
          "candidates": len(res.candidates), "tables_n": res.tables_n,
          "planted_snvs": N_SNVS, "snvs_recovered": N_SNVS - len(missed),
          "batches": batches, "launches": launches, "peak_device_bytes": peak,
          "device": device, "check_s": t6 - t5,
          # the card's k-mer demand: the reads' k-mer windows / device-busy seconds, as
          # `doctor --probe-feed` counts supply (cli._CHIP_DEMAND_DEFAULT)
          "device_demand_kmers_per_s": (3 * N_READS * (READ_LEN - K + 1)
                                        / device["busy_s"] if device else None),
          "python_feeder": {**stages(m_py, t8 - t7), "launches": launches_py,
                            "native_feeder_batches": native_batches_py}})
    return dict(paths=paths, report=res.report, batches=batches, samples=samples, ref=ref,
                launches=launches, wall_s=t4 - t3, genome=genome, child_genome=child_genome,
                snvs=snvs, candidates=res.candidates)


def _counters():
    from denovo_kmer_tpu_torch.ops.block_sort import block_sort
    from denovo_kmer_tpu_torch.ops.extract import extract_append
    from denovo_kmer_tpu_torch.ops.partition import partition_kernel
    from denovo_kmer_tpu_torch.ops.table_merge import merge_kernel

    return {"extract_kmers": extract_append, "radix_partition": partition_kernel,
            "block_sort": block_sort, "table_merge": merge_kernel}


def reset_launches():
    for wrapper in _counters().values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches for name, wrapper in _counters().items()}


# ---------------------------------------------------------------------------------------
# phase 5: the multipass paths at full width, on phase 4's BAMs
# ---------------------------------------------------------------------------------------

SPILL_PASSES = 4
STORE_ROWS = 12_000_000


def phase_multipass(work, paths, report, batches):
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import run_trio_multipass, run_trio_spill
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    cfg = EngineConfig(**MAIN_CFG)
    trio = (paths["mom"], paths["dad"], paths["child"], cfg)
    spill_dir = os.path.join(work, "spill")
    windows = 3 * -(-batches // 3 // cfg.accum_batches)  # staging windows of the 3 samples
    runs = [
        # (name, call, expected launches: extract_kmers, radix_partition)
        ("spill_store", lambda m: run_trio_spill(*trio, SPILL_PASSES, metrics=m,
                                                 device_store_rows=STORE_ROWS,
                                                 device="cuda"), (batches, windows)),
        ("spill_host", lambda m: run_trio_spill(*trio, SPILL_PASSES, spill_dir=spill_dir,
                                                metrics=m, device="cuda"),
         (batches, windows)),
        ("spill_host_resumed", lambda m: run_trio_spill(*trio, SPILL_PASSES,
                                                        spill_dir=spill_dir, metrics=m,
                                                        device="cuda"), (0, 0)),
        ("multipass", lambda m: run_trio_multipass(*trio, 2, m, device="cuda"),
         (2 * batches, 0)),
    ]
    out = {}
    for name, run, want in runs:
        m = Metrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the device-store run, the slice's main path, is traced like phase 4's run_trio
        activities = [torch.profiler.ProfilerActivity.CUDA] if name == "spill_store" else []
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(torch.profiler.profile(activities=activities)) \
                if activities else None
            reset_launches()
            t0 = time.perf_counter()
            res = run(m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        device = (device_time(prof, os.path.join(work, f"{name}_trace.json"), wall)
                  if prof is not None else None)
        if res.report != report:
            raise AssertionError(f"{name}: report differs from run_trio's")
        if (launches["extract_kmers"], launches["radix_partition"]) != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        ingested = m.counters.get("reads_ingested", 0)
        if name == "spill_host_resumed" and ingested != 0:
            raise AssertionError(f"the resumed spill decoded {ingested} reads")
        out[name] = {"wall_s": wall, "launches": launches, "reads_ingested": ingested,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(), "device": device,
                     **{f"{k}_s": v for k, v in sorted(m.seconds.items())}}
    emit({"phase": "multipass", "config": MAIN_CFG, "passes": SPILL_PASSES,
          "device_store_rows": STORE_ROWS, "multipass_passes": 2,
          "candidates": report.count("\n") - 1, **out})
    return out


# ---------------------------------------------------------------------------------------
# phase 6: count / probe / resumable count, and length buckets, at phase 4's width
# ---------------------------------------------------------------------------------------

CKPT_ACCUM = 4  # the resumable count's window: four flushes a sample, a cursor after each


def run_counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; (result, wall s, launches)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_launches()


def _cli(argv):
    from denovo_kmer_tpu_torch import cli

    with contextlib.redirect_stderr(io.StringIO()):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv[0]} exited {rc}")
    return out.getvalue()


def _npz(path):
    with np.load(path) as z:
        return z["keys"], z["counts"], json.loads(bytes(z["meta"]).decode())


def _kmer_str(codes):
    return np.frombuffer(b"ACGT", np.uint8)[np.asarray(codes)].tobytes().decode()


def phase_checkpoints(rng, work, main):
    """`count` both parents to .npz through the CLI; a resumable count stopped after its
    first saved cursor and resumed equals the uninterrupted one; run_trio with both .npz
    parents equals phase 4's report; `probe` of 1,000 k-mers prints the counts of the numpy
    reference."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import run_trio
    from denovo_kmer_tpu_torch.utils import checkpoint

    paths, ref = main["paths"], main["ref"]
    cfg = EngineConfig(**MAIN_CFG)
    flags = cli_flags(cfg)
    batches = main["batches"] // 3
    out, npz = {}, {}
    for name in ("mom", "dad"):
        npz[name] = os.path.join(work, f"{name}.npz")
        _, wall, launches = run_counted(lambda: _cli(
            ["count", paths[name], "-o", npz[name], "--accum-batches",
             str(cfg.accum_batches), *flags]))
        if launches["extract_kmers"] != batches:
            raise AssertionError(f"count {name}: {launches} for {batches} batches")
        keys, counts, meta = _npz(npz[name])
        vals = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1].astype(np.uint64)
        if not (np.array_equal(vals, ref[name][0]) and np.array_equal(counts, ref[name][1])):
            raise AssertionError(f"count {name}: the table differs from the numpy reference")
        out[f"count_{name}"] = {"wall_s": wall, "n": meta["n"], "launches": launches,
                                "npz_bytes": os.path.getsize(npz[name])}

    # the resumable count, stopped right after its first cursor is saved, then resumed
    class Stop(Exception):
        pass

    resumed = os.path.join(work, "mom_resumed.npz")
    argv = ["count", paths["mom"], "-o", resumed, "--resume", "--ckpt-every", "1",
            "--accum-batches", str(CKPT_ACCUM), *flags]
    real_save, saved = checkpoint.save_resume, []

    def stop_after_first(path, table, c, cursor, done):
        real_save(path, table, c, cursor, done)
        saved.append(cursor)
        if not done:
            raise Stop()

    checkpoint.save_resume = stop_after_first
    reset_launches()
    try:
        _cli(argv)
        raise AssertionError("the interrupted count ran to its end")
    except Stop:
        pass
    finally:
        checkpoint.save_resume = real_save
    launches_1 = read_launches()
    _, wall_2, launches_2 = run_counted(lambda: _cli(argv))
    if launches_1["extract_kmers"] + launches_2["extract_kmers"] != batches \
            or launches_2["extract_kmers"] == 0:
        raise AssertionError(f"resumed count launches {launches_1} + {launches_2} != "
                             f"{batches} batches")
    got, want = _npz(resumed), _npz(npz["mom"])
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])) \
            or {**got[2], "source": None} != {**want[2], "source": None}:
        raise AssertionError("the resumed count differs from the uninterrupted one")
    out["count_resumed"] = {"cursor": saved[0], "launches_before_stop": launches_1,
                            "launches_resumed": launches_2, "resumed_wall_s": wall_2}

    # run_trio with both checkpoints as parents
    res, wall, launches = run_counted(lambda: run_trio(npz["mom"], npz["dad"],
                                                       paths["child"], cfg, device="cuda"))
    if res.report != main["report"]:
        raise AssertionError("run_trio with .npz parents: report differs from phase 4's")
    if launches["extract_kmers"] != batches:
        raise AssertionError(f"run_trio with .npz parents launched {launches}")
    out["run_trio_npz"] = {"wall_s": wall, "launches": launches,
                           "feed_wait_s": res.metrics.seconds.get("feed_wait", 0.0)}

    # probe: the candidates and random parental k-mers, through the CLI, on both tables
    cands = [line.split("\t")[0] for line in main["report"].splitlines()[1:]][:500]
    _, _, codes = main["samples"]["mom"]
    rows = rng.integers(0, codes.shape[0], 1000 - len(cands))
    starts = rng.integers(0, READ_LEN - K + 1, rows.shape[0])
    kmers = cands + [_kmer_str(codes[r, st:st + K]) for r, st in zip(rows, starts)]
    values = [canonical_of(b"ACGT".index(ch) for ch in s_.encode()) for s_ in kmers]
    for name in ("mom", "dad"):
        t0 = time.perf_counter()
        text = _cli(["probe", npz[name], "--kmers", ",".join(kmers), *flags])
        wall = time.perf_counter() - t0
        rk, rc = ref[name][0], ref[name][1]
        idx = np.searchsorted(rk, np.asarray(values, np.uint64))
        hit = (idx < len(rk)) & (rk[np.minimum(idx, len(rk) - 1)] == np.asarray(values,
                                                                             np.uint64))
        expect = "".join(f"{s_}\t{int(rc[i]) if h else 0}\n"
                         for s_, i, h in zip(kmers, idx, hit))
        if text != expect:
            raise AssertionError(f"probe {name}: counts differ from the numpy reference")
        out[f"probe_{name}"] = {"kmers": len(kmers), "present": int(hit.sum()),
                                "wall_s": wall}
    emit({"phase": "checkpoints", **out})
    return out


def phase_buckets(rng, work, main):
    """A mixed-length trio from the first ``BUCKET_READS`` of phase 4's reads a sample (each
    trimmed to 60-151 bp): run_trio, the device-store spill and the 2-pass re-decode with
    read_len_buckets BUCKETS each equal the unbucketed run_trio on the same BAMs."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import run_trio, run_trio_multipass, run_trio_spill
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    t0 = time.perf_counter()
    samples = {s: tuple(a[:BUCKET_READS] for a in v) for s, v in main["samples"].items()}
    paths, bases = write_mixed_trio(rng, os.path.join(work, "mixed"), samples=samples)
    bam_s = time.perf_counter() - t0
    plain = EngineConfig(**MAIN_CFG)
    buck = dataclasses.replace(plain, read_len_buckets=BUCKETS)
    trio = (paths["mom"], paths["dad"], paths["child"])
    runs = [
        ("run_trio", plain, lambda c, m: run_trio(*trio, c, m, device="cuda")),
        ("run_trio_bucketed", buck, lambda c, m: run_trio(*trio, c, m, device="cuda")),
        ("spill_store_bucketed", buck, lambda c, m: run_trio_spill(
            *trio, c, SPILL_PASSES, device_store_rows=STORE_ROWS, metrics=m,
            device="cuda")),
        ("multipass_bucketed", buck, lambda c, m: run_trio_multipass(*trio, c, 2, m,
                                                                     device="cuda")),
    ]
    out, report = {}, None
    for name, cfg, fn in runs:
        m = Metrics()
        res, wall, launches = run_counted(lambda: fn(cfg, m))
        if report is None:
            report = res.report
            if not res.candidates:
                raise AssertionError("no candidates on the mixed-length trio")
        elif res.report != report:
            raise AssertionError(f"{name}: report differs from the unbucketed run_trio's")
        if launches["extract_kmers"] != m.counters["batches"] or launches["extract_kmers"] == 0:
            raise AssertionError(f"{name}: extract_kmers launched {launches['extract_kmers']} "
                                 f"times for {m.counters['batches']} batches")
        if (launches["radix_partition"] > 0) != name.startswith("spill"):
            raise AssertionError(f"{name}: radix_partition launched "
                                 f"{launches['radix_partition']} times")
        out[name] = {"wall_s": wall, "launches": launches, "batches": m.counters["batches"],
                     "kmers_extracted": m.counters["kmers_extracted"],
                     **{f"{k}_s": v for k, v in sorted(m.seconds.items())}}
    emit({"phase": "buckets", "buckets": list(BUCKETS), "reads_per_sample": BUCKET_READS,
          "bases": bases, "bam_write_s": bam_s,
          "candidates": report.count("\n") - 1, **out})
    return out


# ---------------------------------------------------------------------------------------
# phase 7: the multi-k sweep, cohort mode, evidence and sites, at phase 4's width
# ---------------------------------------------------------------------------------------

SWEEP_KS = (15, 21, 31, 41)


@contextlib.contextmanager
def no_plain_extraction():
    """Any call of the extraction's plain version fails: on the card every path launches
    the kernel."""
    from denovo_kmer_tpu_torch.ops import extract

    real = extract.append_plain

    def refuse(*a, **kw):
        raise AssertionError("append_plain ran on a path on the card")

    extract.append_plain = refuse
    try:
        yield
    finally:
        extract.append_plain = real


def _add_launches(total, counts):
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n


@contextlib.contextmanager
def launches_of(module, name, out, carried):
    """Record in ``out`` the launches and wall seconds of the calls of ``module.name`` (a
    step inside a larger run, such as the evidence pass of `call --evidence-out`): every
    count is set to 0 just before each call and read just after. The counts of the larger
    run go on in ``carried``: what it counted before the call, and the call's own."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        _add_launches(carried, read_launches())
        reset_launches()
        t0 = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        counts = read_launches()
        reset_launches()
        out["wall_s"] = out.get("wall_s", 0.0) + time.perf_counter() - t0
        _add_launches(out.setdefault("launches", {}), counts)
        _add_launches(carried, counts)
        return res

    setattr(module, name, wrapped)
    try:
        yield out
    finally:
        setattr(module, name, real)


def phase_sweep(main):
    """run_trio_multi_k at (15, 21, 31, 41) on phase 4's BAMs: one decode a sample, four
    extractions a batch. k=31's report is phase 4's; each k's candidates and tables_n
    equal the numpy reference at that k (from the sampled codes) and run_trio's at that k;
    every planted SNV lies under a candidate at every k."""
    from denovo_kmer_tpu_torch.cohort import run_trio_multi_k
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import run_trio
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    paths, cfg = main["paths"], EngineConfig(**MAIN_CFG)
    trio = (paths["mom"], paths["dad"], paths["child"])
    m = Metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep, wall, launches = run_counted(
        lambda: run_trio_multi_k(*trio, cfg, SWEEP_KS, m, device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    if launches["extract_kmers"] != len(SWEEP_KS) * main["batches"]:
        raise AssertionError(f"the sweep launched extract_kmers {launches['extract_kmers']} "
                             f"times for {main['batches']} batches x {len(SWEEP_KS)} ks")
    if sweep[K].report != main["report"]:
        raise AssertionError("the sweep's k=31 report differs from phase 4's")
    t0 = time.perf_counter()
    refs = references({(k, name): (codes, k) for k in SWEEP_KS if k != K
                       for name, (_, _, codes) in main["samples"].items()})
    for k in SWEEP_KS:
        ref = main["ref"] if k == K else {name: refs.pop((k, name))
                                          for name in main["samples"]}
        if sweep[k].candidates != reference_candidates(ref, dataclasses.replace(cfg, k=k)):
            raise AssertionError(f"the sweep at k={k}: candidates differ from the numpy "
                                 "reference")
        want_n = {name: len(ref[name][0]) for name in ("mom", "dad", "child")}
        if sweep[k].tables_n != want_n:
            raise AssertionError(f"the sweep at k={k}: tables_n {sweep[k].tables_n}, the "
                                 f"numpy reference {want_n}")
        del ref
    check_s = time.perf_counter() - t0
    singles = {}
    for k in SWEEP_KS:
        mk = Metrics()
        torch.cuda.reset_peak_memory_stats()
        res, wall_k, launches_k = run_counted(
            lambda: run_trio(*trio, dataclasses.replace(cfg, k=k), mk, device="cuda"))
        if (res.report, res.tables_n) != (sweep[k].report, sweep[k].tables_n):
            raise AssertionError(f"the sweep at k={k} differs from run_trio at k={k}")
        missed = snvs_missed(sweep[k].candidates, main["child_genome"], main["snvs"], k)
        if missed:
            raise AssertionError(f"planted SNVs under no candidate at k={k}: {missed}")
        singles[k] = {"wall_s": wall_k, "feed_wait_s": mk.seconds.get("feed_wait", 0.0),
                      "launches": launches_k["extract_kmers"],
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "candidates": len(res.candidates), "tables_n": res.tables_n}
    out = {"ks": list(SWEEP_KS), "wall_s": wall, "feed_wait_s": m.seconds.get("feed_wait", 0.0),
           "peak_device_bytes": peak, "launches": launches, "reference_check_s": check_s,
           "reads_ingested": m.counters["reads_ingested"],
           "kmers_extracted": m.counters["kmers_extracted"],
           **{f"{key}_s": v for key, v in sorted(m.seconds.items()) if key != "feed_wait"},
           "run_trio_sum_wall_s": sum(r["wall_s"] for r in singles.values()),
           "run_trio_sum_feed_wait_s": sum(r["feed_wait_s"] for r in singles.values()),
           "run_trio": singles}
    emit({"phase": "sweep", "config": MAIN_CFG, **out})
    return out


def phase_cohort(rng, work, main):
    """`cohort` through the CLI with a manifest of two trios on phase 4's genome: phase 4's
    and a trio B with its own planted SNVs, whose run_trio candidates equal the numpy
    reference. Each trio's TSV equals its run_trio report and the parental superset equals
    the numpy union of the four parents' counts."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import run_trio

    cfg = EngineConfig(**MAIN_CFG)
    t0 = time.perf_counter()
    genome = main["genome"]
    child_b = genome.copy()
    snvs_b = np.sort(rng.choice(np.arange(1000, GENOME_LEN - 1000), N_SNVS, replace=False))
    child_b[snvs_b] = (child_b[snvs_b] + rng.integers(1, 4, N_SNVS)) % 4
    samples_b = {"mom": sample_reads(rng, genome, 0.0), "dad": sample_reads(rng, genome, 0.0),
                 "child": sample_reads(rng, child_b, 0.001)}
    os.makedirs(os.path.join(work, "trio_b"), exist_ok=True)
    paths_b = {}
    for name, (pos, rev, codes) in samples_b.items():
        paths_b[name] = os.path.join(work, "trio_b", f"{name}.bam")
        write_bam(paths_b[name], f"{name}_b", codes, pos, rev, GENOME_LEN)
    data_s = time.perf_counter() - t0
    res_b, wall_b, _ = run_counted(
        lambda: run_trio(paths_b["mom"], paths_b["dad"], paths_b["child"], cfg, device="cuda"))
    ref_b = references({name: (codes, K) for name, (_, _, codes) in samples_b.items()})
    if res_b.candidates != reference_candidates(ref_b, cfg):
        raise AssertionError("trio B: candidates differ from the numpy reference")
    # a planted SNV under no candidate is reported with the reading that explains it: the
    # child reads over it and the child counts of the k-mers over it (numpy reference)
    child_keys, child_counts = ref_b["child"][:2]
    child_pos = samples_b["child"][0]
    missed_b = []
    for p in snvs_missed(res_b.candidates, child_b, snvs_b):
        vals = np.array([canonical_of(child_b[st:st + K]) for st in range(p - K + 1, p + 1)],
                        np.uint64)
        at = np.minimum(np.searchsorted(child_keys, vals), len(child_keys) - 1)
        counts = np.where(child_keys[at] == vals, child_counts[at], 0)
        missed_b.append({"pos": int(p), "min_child_count": cfg.min_child_count,
                         "child_reads_over": int(((child_pos <= p)
                                                  & (p < child_pos + READ_LEN)).sum()),
                         "child_kmer_counts": [int(c) for c in counts]})

    pa = main["paths"]
    manifest = os.path.join(work, "cohort.tsv")
    with open(manifest, "w") as f:
        f.write(f"A\t{pa['mom']}\t{pa['dad']}\t{pa['child']}\n"
                f"B\t{paths_b['mom']}\t{paths_b['dad']}\t{paths_b['child']}\n")
    outdir = os.path.join(work, "cohort")
    torch.cuda.reset_peak_memory_stats()
    _, wall, launches = run_counted(lambda: _cli(
        ["cohort", manifest, "-o", outdir, "--accum-batches", str(cfg.accum_batches),
         *cli_flags(cfg)]))
    peak = torch.cuda.max_memory_allocated()
    if launches["extract_kmers"] != 2 * main["batches"]:
        raise AssertionError(f"the cohort launched extract_kmers {launches['extract_kmers']} "
                             f"times for 2 x {main['batches']} batches")
    for name, want in (("A", main["report"]), ("B", res_b.report)):
        with open(os.path.join(outdir, f"{name}.candidates.tsv")) as f:
            if f.read() != want:
                raise AssertionError(f"cohort trio {name}: TSV differs from its run_trio report")

    keys, counts, meta = _npz(os.path.join(outdir, "parental_superset.npz"))
    refs = [main["ref"]["mom"], main["ref"]["dad"], ref_b["mom"], ref_b["dad"]]
    union, inverse = np.unique(np.concatenate([r[0] for r in refs]), return_inverse=True)
    union_counts = np.zeros(union.shape[0], np.int64)
    np.add.at(union_counts, inverse, np.concatenate([r[1] for r in refs]).astype(np.int64))
    vals = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1].astype(np.uint64)
    if meta["n"] != union.shape[0] or not (np.array_equal(vals, union)
                                           and np.array_equal(counts, union_counts)):
        raise AssertionError("the parental superset differs from the numpy union")
    out = {"trios": 2, "data_s": data_s, "wall_s": wall, "launches": launches,
           "peak_device_bytes": peak, "superset_n": meta["n"],
           "candidates": {"A": main["report"].count("\n") - 1,
                          "B": len(res_b.candidates)},
           "trio_b_snvs_under_no_candidate": missed_b,
           "run_trio_b_wall_s": wall_b}
    emit({"phase": "cohort", "config": MAIN_CFG, **out})
    return out


def phase_evidence_sites(work, main):
    """`call --evidence-out ev.bam --sites-out sites.tsv` through the CLI on phase 4's
    trio: the evidence BAM holds exactly the child reads with a valid window whose canonical
    k-mer is a candidate (numpy, from the sampled codes), and every planted SNV lies inside
    a chrS site, each of which holds one."""
    from denovo_kmer_tpu_torch import pipeline, sites
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.bam import read_bam_records

    cfg = EngineConfig(**MAIN_CFG)
    pa = main["paths"]
    cands, ev_bam, sites_tsv = (os.path.join(work, n)
                                for n in ("call.tsv", "evidence.bam", "sites.tsv"))
    ev_stats, site_stats, call_launches = {}, {}, {}
    with launches_of(pipeline, "run_evidence", ev_stats, call_launches), \
            launches_of(sites, "group_sites", site_stats, call_launches):
        _, wall, rest = run_counted(lambda: _cli(
            ["call", "--mom", pa["mom"], "--dad", pa["dad"], "--child", pa["child"],
             "-o", cands, "--evidence-out", ev_bam, "--sites-out", sites_tsv,
             "--accum-batches", str(cfg.accum_batches), *cli_flags(cfg)]))
    _add_launches(call_launches, rest)
    launches = {"call_evidence_sites": call_launches, "evidence": ev_stats["launches"],
                "sites": site_stats["launches"]}
    per_batch = main["batches"] // 3
    want = {"call_evidence_sites": main["batches"] + 2 * per_batch, "evidence": per_batch,
            "sites": per_batch}
    got = {name: v["extract_kmers"] for name, v in launches.items()}
    if got != want:
        raise AssertionError(f"extract_kmers launches {got}, expected {want}")
    with open(cands) as f:
        if f.read() != main["report"]:
            raise AssertionError("call --evidence-out: the report differs from phase 4's")

    t0 = time.perf_counter()
    vals, valid = window_values(main["samples"]["child"][2])
    cand_vals = np.array(sorted(v for v, _, _, _ in main["candidates"]), np.uint64)
    hit = (np.isin(vals, cand_vals) & valid).any(axis=1)
    del vals, valid
    want_names = {f"child_r{i}" for i in np.nonzero(hit)[0]}
    got_names = [r.name for r in read_bam_records(ev_bam)]
    if len(got_names) != len(set(got_names)) or set(got_names) != want_names:
        raise AssertionError(f"evidence: {len(got_names)} reads, the reference "
                             f"{len(want_names)}")
    rows = [line.split("\t") for line in open(sites_tsv).read().splitlines()[1:]]
    spans = [(ref, int(a), int(b)) for ref, a, b, *_ in rows]
    snvs = main["snvs"]
    if not spans or any(ref != "chrS" for ref, _, _ in spans):
        raise AssertionError(f"sites off the reference: {spans[:5]}")
    if any(not any(a <= p < b for _, a, b in spans) for p in snvs):
        raise AssertionError("a planted SNV lies inside no site")
    if any(not any(a <= p < b for p in snvs) for _, a, b in spans):
        raise AssertionError("a site holds no planted SNV")
    out = {"wall_s": wall, "launches": launches, "evidence_reads": len(got_names),
           "sites": len(spans), "evidence_wall_s": ev_stats["wall_s"],
           "sites_wall_s": site_stats["wall_s"], "check_s": time.perf_counter() - t0}
    emit({"phase": "evidence_sites", "config": MAIN_CFG, **out})
    return {**out, "hit_reads": set(np.nonzero(hit)[0].tolist())}


# ---------------------------------------------------------------------------------------
# phase 8: the inputs -- CRAM, BAM/CRAM regions, SAM, remote URLs, --profile-dir
# ---------------------------------------------------------------------------------------

#: each sample's CRAM: block method (an attribute of io/cram.py) and CRAM version
CRAM_CODECS = {"mom": ("M_RANS", (3, 0)), "dad": ("M_RANSNX16", (3, 1)),
               "child": ("M_ARITH", (3, 1))}
REGION = "chrS:1000001-3000000"  # 1-based inclusive: 0-based [1,000,000, 3,000,000)
REGION_SPAN = (1_000_000, 3_000_000)
#: two BED intervals (0-based half-open) 100 bp apart: a read over the gap overlaps both
REGIONS_BED = ((500_000, 1_000_000), (1_000_100, 1_600_000))


class RangeHandler(http.server.SimpleHTTPRequestHandler):
    """SimpleHTTPRequestHandler plus RFC 7233 single-range GETs (206): a BAI-driven region
    read over HTTP seeks by Range, which SimpleHTTPRequestHandler alone ignores."""

    def send_head(self):
        rng = self.headers.get("Range")
        if not rng or not rng.startswith("bytes="):
            return super().send_head()
        try:
            f = open(self.translate_path(self.path), "rb")
        except OSError:
            self.send_error(404)
            return None
        with f:
            size = os.fstat(f.fileno()).st_size
            a, _, b = rng[len("bytes="):].partition("-")
            start = int(a) if a else max(size - int(b), 0)
            end = min(int(b), size - 1) if (a and b) else size - 1
            if start >= size:
                self.send_error(416)
                return None
            f.seek(start)
            data = f.read(end - start + 1)
        self.send_response(206)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        return io.BytesIO(data)

    def log_message(self, *a):
        pass


@contextlib.contextmanager
def serve(directory):
    """Serve ``directory`` on 127.0.0.1 from a thread; yields the base URL."""
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(RangeHandler, directory=directory))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


@contextlib.contextmanager
def counting(module, name, counts):
    """Count the calls of ``module.name`` in ``counts[name]``."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return real(*a, **kw)

    setattr(module, name, wrapped)
    try:
        yield counts
    finally:
        setattr(module, name, real)


def stored_codes(codes, rev):
    """Full-length reads in reference orientation, as bam_records stores them."""
    return np.where(rev[:, None], np.where(codes < 4, 3 - codes, 4)[:, ::-1], codes)


def write_fasta(path, text, name="chrS"):
    """The sequence ``text`` as contig ``name`` in 60-column lines, with its .fai (the
    port's build_fai)."""
    from denovo_kmer_tpu_torch.io.fasta import build_fai

    with open(path, "w") as f:
        f.write(f">{name}\n")
        f.write("".join(text[i:i + 60] + "\n" for i in range(0, len(text), 60)))
    build_fai(path)


def write_cram_sample(path, stored, starts, flags, genome_text, codec):
    """One sample's reads (rows of ``stored`` in file order, 0-based ``starts``) as a
    reference-based CRAM through the port's writer, with its .crai; → seconds. Runs in a
    worker process of its own."""
    from denovo_kmer_tpu_torch.io import cram
    from denovo_kmer_tpu_torch.io.crai import write_crai

    t0 = time.perf_counter()
    L = stored.shape[1]
    text = np.frombuffer(b"ACGTN", np.uint8)[stored].tobytes().decode()
    mapped = [(text[i * L:(i + 1) * L], int(starts[i]) + 1, int(flags[i]), None)
              for i in range(len(starts))]
    method, version = codec
    cram.write_cram(path, [], mapped=mapped, reference=genome_text,
                    method=getattr(cram, method), version=version,
                    sam_header=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrS\t"
                               f"LN:{len(genome_text)}\n")
    write_crai(path)
    return time.perf_counter() - t0


def write_sorted_bam(path, name, codes, pos, rev, order):
    """``write_bam`` of the rows in ``order`` (coordinate order) and its .bai (the port's
    write_bai); → seconds. Runs in a worker process of its own."""
    from denovo_kmer_tpu_torch.io.bai import write_bai

    t0 = time.perf_counter()
    write_bam(path, name, codes, pos, rev, GENOME_LEN, order=order)
    write_bai(path)
    return time.perf_counter() - t0


def overlapping(pos, intervals, read_len=READ_LEN):
    """Rows whose reference span [pos, pos + read_len) meets any of the 0-based half-open
    ``intervals`` (bai.record_ref_span of a full-length match), each row once."""
    hit = np.zeros(len(pos), bool)
    for b, e in intervals:
        hit |= (pos < e) & (pos + read_len > b)
    return hit


def tsv_candidates(path):
    """(value, child, mom, dad) rows of a candidate TSV."""
    from denovo_kmer_tpu_torch.oracle.scalar import encode_kmer

    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if not line.startswith("#")]
    return sorted((encode_kmer(r[0]), int(r[1]), int(r[2]), int(r[3])) for r in rows)


def phase_inputs(work, main, evidence7):
    """CRAM, region, SAM, remote and --profile-dir inputs at phase 4's width, each held to
    phase 4's report, phase 7's evidence or the numpy reference over the reads it reads."""
    import glob

    from denovo_kmer_tpu_torch import pipeline, sites
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io import bai, native, sam
    from denovo_kmer_tpu_torch.io.bam import read_bam_records
    from denovo_kmer_tpu_torch.io.cram import CramReader
    from denovo_kmer_tpu_torch.io.fasta import load_reference_indexed
    from denovo_kmer_tpu_torch.ops import pack
    from denovo_kmer_tpu_torch.pipeline import run_trio, run_trio_spill
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    d = os.path.join(work, "inputs")
    os.makedirs(d)
    cfg = EngineConfig(**MAIN_CFG)
    B, names = cfg.batch_reads, ("mom", "dad", "child")
    samples, want_report, batches = main["samples"], main["report"], main["batches"]
    out, by_path = {}, {}

    # ---- fixtures: the FASTA, coordinate-sorted BAMs + BAI, CRAMs + CRAI, a SAM child ----
    t0 = time.perf_counter()
    fa = os.path.join(d, "genome.fa")
    genome_text = np.frombuffer(b"ACGTN", np.uint8)[main["genome"]].tobytes().decode()
    write_fasta(fa, genome_text)
    order = {s: np.argsort(samples[s][0], kind="stable") for s in names}
    stored = {s: stored_codes(samples[s][2], samples[s][1])[order[s]] for s in names}
    paths = {s: {"bam": os.path.join(d, f"{s}.bam"), "cram": os.path.join(d, f"{s}.cram")}
             for s in names}
    with concurrent.futures.ProcessPoolExecutor(
            6, mp_context=multiprocessing.get_context("spawn")) as pool:
        crams = {s: pool.submit(write_cram_sample, paths[s]["cram"], stored[s],
                                samples[s][0][order[s]],
                                np.where(samples[s][1], 0x10, 0)[order[s]], genome_text,
                                CRAM_CODECS[s]) for s in names}
        bams = {s: pool.submit(write_sorted_bam, paths[s]["bam"], s, samples[s][2],
                               samples[s][0], samples[s][1], order[s]) for s in names}
        t1 = time.perf_counter()
        sam_child = sam.write_sam(os.path.join(d, "child.sam"),
                                  list(bam_records("child", samples["child"][2],
                                                   samples["child"][0], samples["child"][1])),
                                  references=[("chrS", GENOME_LEN)])
        sam_write_s = time.perf_counter() - t1
        cram_write_s = {s: w.result() for s, w in crams.items()}
        bam_write_s = {s: w.result() for s, w in bams.items()}
    fixtures_s = time.perf_counter() - t0

    # ---- the CRAMs decode to the BAMs' sequences (a fixture fault is not a port fault) ----
    ref_map = load_reference_indexed(fa)
    cram_decode_s = {}
    for s in names:
        t0 = time.perf_counter()
        with open(paths[s]["cram"], "rb") as f:
            chunks = list(CramReader(f, reference=ref_map).iter_seq_chunks(
                cfg.filter_flag_mask, cfg.max_read_len, with_quals=False))
        cram_decode_s[s] = time.perf_counter() - t0
        flat = np.concatenate([c.flat for c in chunks])
        want = np.frombuffer(b"ACGTN", np.uint8)[stored[s]].ravel()
        if not np.array_equal(flat, want):
            raise AssertionError(f"{s}.cram decodes to other sequences than its reads")
    if not native.native_available():
        raise AssertionError("the native codecs did not build")

    cfg_ref = dataclasses.replace(cfg, reference_fasta=fa)
    cram_trio = [paths[s]["cram"] for s in names]

    def trio_run(name, fn, want_launches, want_partition=0):
        m = Metrics()
        res, wall, launches = run_counted(lambda: fn(m))
        if launches["extract_kmers"] != want_launches:
            raise AssertionError(f"{name}: extract_kmers launched {launches['extract_kmers']}"
                                 f" times, expected {want_launches}")
        if launches["radix_partition"] != want_partition:
            raise AssertionError(f"{name}: radix_partition launched "
                                 f"{launches['radix_partition']} times, expected "
                                 f"{want_partition}")
        by_path[name] = launches
        out[name] = {"wall_s": wall, "feed_wait_s": m.seconds.get("feed_wait", 0.0),
                     "launches": launches, "reads_ingested": m.counters["reads_ingested"]}
        return res

    # ---- the CRAM trio, through the columnar feeder ----
    calls = {}
    with counting(pack, "pack_chunks", calls), counting(pipeline, "_record_stream", calls):
        res = trio_run("cram_trio", lambda m: run_trio(*cram_trio, cfg_ref, m, device="cuda"),
                       batches)
    if calls != {"pack_chunks": 3}:
        raise AssertionError(f"the CRAM trio's feeders: {calls}, expected pack_chunks x 3")
    if res.report != want_report:
        raise AssertionError("run_trio on the CRAM trio: report differs from phase 4's")
    windows = 3 * -(-batches // 3 // cfg.accum_batches)
    res = trio_run("cram_spill_store", lambda m: run_trio_spill(
        *cram_trio, cfg_ref, SPILL_PASSES, metrics=m, device_store_rows=STORE_ROWS,
        device="cuda"), batches, windows)
    if res.report != want_report:
        raise AssertionError("run_trio_spill on the CRAM trio: report differs from phase 4's")

    # ---- regions: the numpy reference over the reads each region reads ----
    def region_reference(intervals):
        masks = {s: overlapping(samples[s][0], intervals) for s in names}
        ref = references({s: (samples[s][2][masks[s]], K) for s in names})
        return (reference_candidates(ref, cfg), {s: len(ref[s][0]) for s in names},
                sum(-(-int(m_.sum()) // B) for m_ in masks.values()),
                {s: int(m_.sum()) for s, m_ in masks.items()})

    t0 = time.perf_counter()
    want_region, want_n, region_batches, region_reads = region_reference([REGION_SPAN])
    want_bed, _, bed_batches, bed_reads = region_reference(REGIONS_BED)
    both = {s: int(overlapping(samples[s][0], REGIONS_BED[:1]).__and__(
        overlapping(samples[s][0], REGIONS_BED[1:])).sum()) for s in names}
    region_check_s = time.perf_counter() - t0
    bam_trio = [paths[s]["bam"] for s in names]
    region_reports = {}
    for name, trio, c in (("bam_region", bam_trio, cfg), ("cram_region", cram_trio, cfg_ref)):
        res = trio_run(name, lambda m: run_trio(*trio, c, m, region=REGION, device="cuda"),
                       region_batches)
        if res.candidates != want_region or res.tables_n != want_n:
            raise AssertionError(f"{name}: candidates or tables_n differ from the numpy "
                                 "reference over the region's reads")
        region_reports[name] = res.report
    bed = os.path.join(d, "targets.bed")
    with open(bed, "w") as f:
        f.write("".join(f"chrS\t{b}\t{e}\n" for b, e in REGIONS_BED))
    bed_tsv = os.path.join(d, "bed.tsv")
    _, wall, launches = run_counted(lambda: _cli(
        ["call", "--mom", bam_trio[0], "--dad", bam_trio[1], "--child", bam_trio[2],
         "-o", bed_tsv, "--regions-bed", bed, "--accum-batches", str(cfg.accum_batches),
         *cli_flags(cfg)]))
    if tsv_candidates(bed_tsv) != sorted(want_bed):
        raise AssertionError("call --regions-bed differs from the numpy reference")
    if launches["extract_kmers"] != bed_batches:
        raise AssertionError(f"call --regions-bed: {launches['extract_kmers']} launches, "
                             f"expected {bed_batches}")
    by_path["bam_regions_bed"] = launches
    out["bam_regions_bed"] = {"wall_s": wall, "launches": launches}
    out["regions"] = {"region": REGION, "region_reads": region_reads,
                      "region_batches": region_batches, "bed": [list(i) for i in REGIONS_BED],
                      "bed_reads": bed_reads, "bed_reads_over_both": both,
                      "bed_batches": bed_batches, "candidates": len(want_region),
                      "bed_candidates": len(want_bed), "reference_s": region_check_s}

    # ---- a SAM child beside BAM parents ----
    pa = main["paths"]
    res = trio_run("sam_child", lambda m: run_trio(pa["mom"], pa["dad"], sam_child, cfg, m,
                                                   device="cuda"), batches)
    if res.report != want_report:
        raise AssertionError("run_trio with a SAM child: report differs from phase 4's")

    # ---- remote: phase 4's BAMs and the sorted BAMs (+ BAI) over HTTP ----
    with serve(work) as url:
        urls = [f"{url}/{os.path.relpath(pa[s], work)}" for s in names]
        res = trio_run("http_trio", lambda m: run_trio(*urls, cfg, m, device="cuda"), batches)
        if res.report != want_report:
            raise AssertionError("run_trio over HTTP: report differs from phase 4's")
        sorted_urls = [f"{url}/inputs/{s}.bam" for s in names]
        if bai.load_index_for(sorted_urls[0]) is None:
            raise AssertionError("the BAI beside the URL was not found")
        res = trio_run("http_region", lambda m: run_trio(*sorted_urls, cfg, m, region=REGION,
                                                         device="cuda"), region_batches)
        if res.report != region_reports["bam_region"]:
            raise AssertionError("a region over HTTP differs from the local region report")

    # ---- call --evidence-out --sites-out on the CRAM trio ----
    ev_bam, sites_tsv, tsv = (os.path.join(d, n) for n in ("ev.bam", "sites.tsv", "c.tsv"))
    ev_stats, site_stats, call_launches = {}, {}, {}
    with launches_of(pipeline, "run_evidence", ev_stats, call_launches), \
            launches_of(sites, "group_sites", site_stats, call_launches):
        _, wall, rest = run_counted(lambda: _cli(
            ["call", *sum((["--" + s, p] for s, p in zip(names, cram_trio)), []),
             "-o", tsv, "--reference", fa, "--evidence-out", ev_bam, "--sites-out", sites_tsv,
             "--accum-batches", str(cfg.accum_batches), *cli_flags(cfg)]))
    _add_launches(call_launches, rest)
    per_sample = batches // 3
    got = {"cram_call_evidence_sites": call_launches, "cram_evidence": ev_stats["launches"],
           "cram_sites": site_stats["launches"]}
    want = {"cram_call_evidence_sites": batches + 2 * per_sample,
            "cram_evidence": per_sample, "cram_sites": per_sample}
    if {k_: v["extract_kmers"] for k_, v in got.items()} != want:
        raise AssertionError(f"CRAM evidence/sites launches {got}, expected {want}")
    by_path.update(got)
    with open(tsv) as f:
        if f.read() != want_report:
            raise AssertionError("call on the CRAM trio: the report differs from phase 4's")
    # mapped CRAM records are named m<ordinal in the file>: map them back to the reads
    rows = [int(r.name[1:]) for r in read_bam_records(ev_bam)]
    got_reads = set(order["child"][rows].tolist())
    if len(rows) != len(got_reads) or got_reads != evidence7["hit_reads"]:
        raise AssertionError(f"CRAM evidence: {len(rows)} reads, phase 7's "
                             f"{len(evidence7['hit_reads'])}")
    # a CRAM record carries no alignment position (in both packages), so sites group by the
    # read graph: every candidate k-mer lies in exactly one site
    with open(sites_tsv) as f:
        site_rows = [line.rstrip("\n").split("\t") for line in f if not line.startswith("#")]
    site_kmers = [km for r in site_rows for km in r[-1].split(",")]
    cand_kmers = [line.split("\t")[0] for line in want_report.splitlines()[1:]]
    if sorted(site_kmers) != sorted(cand_kmers):
        raise AssertionError("CRAM sites: the sites' k-mers are not the candidates, once each")
    out["cram_evidence_sites"] = {"wall_s": wall, "evidence_reads": len(rows),
                                  "sites": len(site_rows),
                                  "evidence_wall_s": ev_stats["wall_s"],
                                  "sites_wall_s": site_stats["wall_s"], "launches": got}

    # ---- call --profile-dir on the BAM trio ----
    pdir = os.path.join(d, "profile")
    ptsv = os.path.join(d, "profiled.tsv")
    _, wall, launches = run_counted(lambda: _cli(
        ["call", "--mom", pa["mom"], "--dad", pa["dad"], "--child", pa["child"], "-o", ptsv,
         "--profile-dir", pdir, "--accum-batches", str(cfg.accum_batches), *cli_flags(cfg)]))
    traces = glob.glob(os.path.join(pdir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile-dir wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernel_events = [e for e in events if e.get("cat") == "kernel"
                     and "extract_kmers" in e.get("name", "")]
    if not kernel_events:
        raise AssertionError("the profile trace names no extract_kmers kernel")
    with open(ptsv) as f:
        if f.read() != want_report:
            raise AssertionError("call --profile-dir: the report differs from phase 4's")
    if launches["extract_kmers"] != batches:
        raise AssertionError(f"call --profile-dir: {launches['extract_kmers']} launches")
    by_path["profile_call"] = launches
    out["profile_call"] = {"wall_s": wall, "trace_bytes": os.path.getsize(traces[0]),
                           "events": len(events), "extract_kernel_events": len(kernel_events),
                           "launches": launches}

    emit({"phase": "inputs", "config": MAIN_CFG, "fixtures_s": fixtures_s,
          "cram_codecs": {s: f"{m_} CRAM {v[0]}.{v[1]}" for s, (m_, v) in CRAM_CODECS.items()},
          "cram_write_s": cram_write_s, "cram_decode_s": cram_decode_s,
          "cram_bytes": {s: os.path.getsize(paths[s]["cram"]) for s in names},
          "bam_bytes": {s: os.path.getsize(paths[s]["bam"]) for s in names},
          "sorted_bam_and_bai_write_s": bam_write_s, "sam_write_s": sam_write_s, **out})
    return by_path


def phase_parity_inputs(work, small):
    """cuda == cpu on phase 3's small trio written as CRAMs (each sample's codec, with the
    FASTA), as a SAM child and as sorted BAMs with their BAI, and served over HTTP:
    run_trio on a BAM and a CRAM region, on the CRAM trio, with the SAM child and on the
    URLs gives identical reports on both devices; the full-trio ones equal the BAM trio's."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io import bai, cram, sam
    from denovo_kmer_tpu_torch.io.bam import read_bam_records, sort_bam
    from denovo_kmer_tpu_torch.io.crai import write_crai
    from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio
    from denovo_kmer_tpu_torch.pipeline import run_trio

    d = os.path.dirname(small["child"])
    spec = TrioSpec(genome_len=20000, seed=0)  # phase_parity's trio
    reference = make_trio(spec).reference
    cfg = EngineConfig(k=K, max_read_len=128, batch_reads=1024, accum_batches=1,
                       table_capacity=1 << 16)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, reference, spec.ref_name)
    cram_cfg = dataclasses.replace(cfg, reference_fasta=fa)
    names = ("mom", "dad", "child")
    header = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{spec.ref_name}\tLN:{len(reference)}\n"
    sorted_bams, crams = [], []
    for s_ in names:
        sb = sort_bam(small[s_], os.path.join(d, f"{s_}.sorted.bam"))
        bai.write_bai(sb)
        sorted_bams.append(sb)
        recs = list(read_bam_records(sb))
        crams.append(os.path.join(d, f"{s_}.cram"))
        method, version = CRAM_CODECS[s_]
        cram.write_cram(crams[-1], [], mapped=[(r.seq, r.pos + 1, r.flag, r.qual)
                                               for r in recs],
                        reference=reference, method=getattr(cram, method), version=version,
                        sam_header=header)
        write_crai(crams[-1])
    sam_child = sam.write_sam(os.path.join(d, "child.sam"),
                              list(read_bam_records(small["child"])),
                              references=[(spec.ref_name, len(reference))])
    bam_trio = (small["mom"], small["dad"], small["child"])
    want = run_trio(*bam_trio, cfg, device="cuda").report
    region = f"{spec.ref_name}:5001-15000"
    out = {}
    with serve(d) as url:
        runs = {
            "bam_region": (sorted_bams, cfg, region), "cram_region": (crams, cram_cfg, region),
            "cram": (crams, cram_cfg, None), "sam_child": ((*bam_trio[:2], sam_child), cfg,
                                                           None),
            "http": ([f"{url}/{os.path.basename(p_)}" for p_ in bam_trio], cfg, None)}
        for name, (trio, c, reg) in runs.items():
            gpu, wall, launches = run_counted(
                lambda: run_trio(*trio, c, region=reg, device="cuda"))
            t0 = time.perf_counter()
            cpu = run_trio(*trio, c, region=reg, device="cpu")
            cpu_s = time.perf_counter() - t0
            if (gpu.report, gpu.tables_n) != (cpu.report, cpu.tables_n):
                raise AssertionError(f"{name}: run_trio on cuda != on cpu")
            if reg is None and gpu.report != want:
                raise AssertionError(f"{name}: report differs from the BAM trio's")
            if launches["extract_kmers"] == 0 or gpu.report.count("\n") < 2:
                raise AssertionError(f"{name}: no extraction on the card, or no candidate")
            out[name] = {"cuda_s": wall, "cpu_s": cpu_s,
                         "launches": launches["extract_kmers"],
                         "candidates": gpu.report.count("\n") - 1}
    if out["bam_region"]["launches"] >= out["cram"]["launches"]:
        raise AssertionError("the region run extracted as many batches as the whole trio")
    emit({"phase": "parity_inputs", "region": region, **out})


# ---------------------------------------------------------------------------------------
# phase 9: the sharded engine (--mesh) on one card
# ---------------------------------------------------------------------------------------

MESH = (2, 4)  # the full-width mesh: eight shards, all on the one card
SMALL_MESHES = ((1, 4), (2, 2), (4, 1))


def card_mesh(shape, dev="cuda"):
    """An R x T mesh of one device repeated: the way to run a mesh on one card (make_mesh
    alone takes one card a shard)."""
    from denovo_kmer_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, [torch.device(dev)] * (shape[0] * shape[1]))


def phase_parity_sharded(work, paths):
    """Phase 9's small part, on the card and on the CPU, on phase 3's small trio: the
    sharded trio on (1,4), (2,2), (4,1) at k=31 and k=32 against the single-device run_trio,
    a route-overflow retry (factor 0.05), the sharded multipass (2 passes) and spill (3
    passes, device store), the sharded sweep (15, 32, 33) against the single-device sweep,
    the sharded cohort of two trios (tuples and the superset file) and the sharded probe,
    both plans, against probe_table. Everything equal on both devices."""
    from denovo_kmer_tpu_torch.cohort import (
        TrioPaths,
        run_cohort,
        run_cohort_sharded,
        run_trio_multi_k,
        run_trio_multi_k_sharded,
    )
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.ops.table import probe_table, table_to_numpy
    from denovo_kmer_tpu_torch.parallel.pipeline import (
        run_trio_multipass_sharded,
        run_trio_sharded,
        run_trio_spill_sharded,
    )
    from denovo_kmer_tpu_torch.parallel.probe import make_sharded_probe
    from denovo_kmer_tpu_torch.parallel.sharded_table import ShardedKmerEngine
    from denovo_kmer_tpu_torch.pipeline import build_sample_table, run_trio
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    base = dict(max_read_len=128, batch_reads=1024, accum_batches=1, table_capacity=1 << 16)
    trio = (paths["mom"], paths["dad"], paths["child"])
    second = os.path.join(work, "small_b")  # phase_parity_slice's second trio
    trios = [TrioPaths("a", *trio), TrioPaths("b", *(os.path.join(second, f"{s}.bam")
                                                     for s in ("mom", "dad", "child")))]
    out = {}

    def both(name, run, want=None):
        """``run(device)`` on the card (launches counted from 0) and on the CPU: equal,
        and equal to ``want`` where given."""
        gpu, wall, launches = run_counted(lambda: run("cuda"))
        t0 = time.perf_counter()
        cpu = run("cpu")
        cpu_s = time.perf_counter() - t0
        if gpu != cpu:
            raise AssertionError(f"{name}: the card and the CPU differ")
        if want is not None and gpu != want:
            raise AssertionError(f"{name}: differs from the single-device run")
        if launches["extract_kmers"] == 0 and not name.startswith("probe"):
            raise AssertionError(f"{name} launched no extraction on the card")
        out[name] = {"cuda_s": wall, "cpu_s": cpu_s, "launches": launches}
        return gpu

    def key(res):
        return res.report, res.tables_n

    for k in (31, 32):
        cfg = EngineConfig(k=k, **base)
        want = key(run_trio(*trio, cfg, device="cuda"))
        for shape in SMALL_MESHES:
            c = dataclasses.replace(cfg, mesh_shape=shape)
            both(f"k{k}_{shape[0]}x{shape[1]}",
                 lambda d: key(run_trio_sharded(*trio, c, mesh=card_mesh(shape, d))), want)
    cfg = EngineConfig(k=K, **base)
    want = key(run_trio(*trio, cfg, device="cuda"))

    retries = {}

    def starved(d):
        events = io.StringIO()
        c = dataclasses.replace(cfg, mesh_shape=(1, 4), route_capacity_factor=0.05)
        res = run_trio_sharded(*trio, c, Metrics(json_stream=events),
                               mesh=card_mesh((1, 4), d), max_route_retries=8)
        retries[d] = events.getvalue().count("route_overflow_retry")
        return key(res)

    both("route_retry", starved, want)
    if not retries["cuda"] or retries["cuda"] != retries["cpu"]:
        raise AssertionError(f"the starved route retried {retries} times")
    out["route_retry"]["retries"] = retries["cuda"]
    c22 = dataclasses.replace(cfg, mesh_shape=(2, 2))
    both("multipass2", lambda d: key(run_trio_multipass_sharded(
        *trio, c22, 2, mesh=card_mesh((2, 2), d))), want)
    both("spill3", lambda d: key(run_trio_spill_sharded(
        *trio, c22, 3, 1 << 16, mesh=card_mesh((2, 2), d))), want)
    ks = (15, 32, 33)
    single = {k: key(r) for k, r in run_trio_multi_k(*trio, cfg, ks, device="cuda").items()}
    both("sweep_15_32_33", lambda d: {k: key(r) for k, r in run_trio_multi_k_sharded(
        *trio, c22, ks, mesh=card_mesh((2, 2), d)).items()}, single)

    def cohort(d):
        path = os.path.join(work, f"superset_{d}.npz")
        res, _ = run_cohort_sharded(trios, c22, mesh=card_mesh((2, 2), d), superset_out=path)
        with np.load(path) as z:
            return res, {name: z[name].tobytes() for name in z.files}

    single_res, single_sup = run_cohort(trios, cfg, device="cuda")
    res, sup = both("cohort", cohort)
    if res != {name: r.candidates for name, r in single_res.items()}:
        raise AssertionError("the sharded cohort's candidates differ from run_cohort's")
    sup_n = int(np.frombuffer(sup["n"], np.int32).sum())
    if sup_n != int(single_sup.n):
        raise AssertionError(f"sharded superset holds {sup_n} keys, run_cohort's "
                             f"{int(single_sup.n)}")

    # the sharded probe, both plans: parental keys, absent keys, duplicates, some invalid
    flat = build_sample_table(paths["mom"], cfg, device="cpu")
    keys, _counts, n = table_to_numpy(flat)
    rng = np.random.default_rng(9)
    q = np.concatenate([keys[rng.integers(0, n, 3000)],
                        rng.integers(0, 2**30, size=(1096, 2), dtype=np.uint32)])
    queries = torch.from_numpy(q.astype(np.int64))
    valid = torch.from_numpy(rng.random(len(q)) < 0.9)
    expect = torch.where(valid, probe_table(flat, queries), 0)
    for plan in ("alltoall", "ring"):
        def probe(d, plan=plan):
            eng = ShardedKmerEngine(c22, card_mesh((2, 2), d))
            fn = make_sharded_probe(eng.mesh, dataclasses.replace(
                c22, route_capacity_factor=2.0), plan=plan)
            counts, ovf = fn(eng.place_flat_table(flat), queries.to(d), valid.to(d))
            return counts.cpu().tolist(), int(ovf)

        counts, ovf = both(f"probe_{plan}", probe)
        if ovf or counts != expect.tolist():
            raise AssertionError(f"the {plan} probe differs from probe_table (overflow {ovf})")
    emit({"phase": "parity_sharded", "meshes": [list(s) for s in SMALL_MESHES], **out})
    return out


@contextlib.contextmanager
def timed_stages(stage_s):
    """Add the seconds of the sharded engine's route, fold, finalize and call to
    ``stage_s`` (each call synchronized with the card), for the duration of the block."""
    from denovo_kmer_tpu_torch.parallel import sharded_table

    engine = sharded_table.ShardedKmerEngine
    patched = [(engine, "_route_window", "route"), (engine, "_fold_window", "fold"),
               (engine, "_finalize_tables", "finalize"), (sharded_table, "call_rows", "call")]
    real = [getattr(obj, attr) for obj, attr, _ in patched]

    def synced(fn, stage):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[stage] = stage_s.get(stage, 0.0) + time.perf_counter() - t0
            return res
        return wrapped

    for (obj, attr, stage), fn in zip(patched, real):
        setattr(obj, attr, synced(fn, stage))
    try:
        yield stage_s
    finally:
        for (obj, attr, _), fn in zip(patched, real):
            setattr(obj, attr, fn)


def phase_sharded(main):
    """run_trio_sharded at phase 4's width on a 2x4 mesh of the one card: phase 4's report,
    48 batches x 8 shards extraction launches, under a torch.profiler trace; the route,
    fold, finalize and call seconds (each synchronized); then through the CLI `call --mesh
    2x2` (one card a shard: refused with the JAX package's message) and `call --mesh 1x1`
    (phase 4's report)."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.parallel.pipeline import run_trio_sharded
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    cfg = EngineConfig(**MAIN_CFG, mesh_shape=MESH)
    paths = main["paths"]
    stage_s = {}
    m = Metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_stages(stage_s):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            reset_launches()
            t0 = time.perf_counter()
            res = run_trio_sharded(paths["mom"], paths["dad"], paths["child"], cfg, m,
                                   mesh=card_mesh(MESH))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    trace = os.path.join(os.path.dirname(paths["mom"]), "sharded_trace.json")
    device = device_time(prof, trace, t1 - t0)
    if res.report != main["report"]:
        raise AssertionError("run_trio_sharded on the 2x4 mesh: report differs from phase 4's")
    shards = MESH[0] * MESH[1]
    if launches["extract_kmers"] != main["batches"] * shards:
        raise AssertionError(f"extract_kmers launched {launches['extract_kmers']} times for "
                             f"{main['batches']} batches x {shards} shards")
    if launches["radix_partition"] or launches["block_sort"]:
        raise AssertionError(f"the sharded trio launched {launches}")

    # the CLI: a mesh of one card a shard needs R*T cards; 1x1 is the single-device call
    argv = ["call", "--mom", paths["mom"], "--dad", paths["dad"], "--child", paths["child"],
            *cli_flags(cfg), "--accum-batches", str(cfg.accum_batches)]
    refusal = None
    if torch.cuda.device_count() < 4:
        try:
            _cli([*argv, "--mesh", "2x2"])
        except ValueError as e:
            refusal = str(e)
        want = f"mesh (2, 2) needs 4 devices, have {torch.cuda.device_count()}"
        if refusal != want:
            raise AssertionError(f"call --mesh 2x2 on this host: {refusal!r}, not {want!r}")
    report, wall_1x1, launches_1x1 = run_counted(lambda: _cli([*argv, "--mesh", "1x1"]))
    if report != main["report"]:
        raise AssertionError("call --mesh 1x1: the report differs from phase 4's")
    sec = m.seconds
    out = {"phase": "sharded", "config": MAIN_CFG, "mesh": list(MESH), "devices": "cuda:0 x 8",
           "power": power_line(),
           "wall_s": t1 - t0, "phase4_wall_s": main["wall_s"],
           "feed_wait_s": sec.get("feed_wait", 0.0),
           **{f"{name}_s": sec[name] for name in ("build_mom", "build_dad", "build_child",
                                                  "trio_call")},
           **{f"{stage}_s": t for stage, t in stage_s.items()},
           "candidates": len(res.candidates), "tables_n": res.tables_n,
           "batches": main["batches"], "launches": launches, "peak_device_bytes": peak,
           "device": device, "cli_mesh_2x2": refusal,
           "cli_mesh_1x1": {"wall_s": wall_1x1, "launches": launches_1x1}}
    emit(out)
    return out


# ---------------------------------------------------------------------------------------
# phase 10: multi-process runs over torch.distributed, and the table subcommands
# ---------------------------------------------------------------------------------------

MH_RANKS = 2  # two processes on the one card: gloo (NCCL refuses two ranks on one GPU)
MH_LOCAL = 4  # each rank's local devices: cuda:0 four times
MH_TIMEOUT = 60.0  # init_process_group timeout: how long a collective waits for a dead peer
MH_JOIN_S = 360.0  # the longest a launch may take before every worker is killed
MH_SPILL_PASSES = 2
MH_READS = N_READS // 4  # phase 10's depth: the first quarter of each phase-4 sample's reads
# phase 5's device store holds 12,000,000 rows a pass over 4 passes; the same 48,000,000
# rows over 2 passes and 8 shards
MH_SPILL_ROWS = STORE_ROWS * SPILL_PASSES // MH_SPILL_PASSES // (MESH[0] * MESH[1])


def _timed_stepper(real, feed_s):
    """``multihost._make_stepper`` whose batches add their wait (decode, pack, step
    alignment) to ``feed_s[0]``."""
    def make(*a, **kw):
        it = iter(real(*a, **kw))
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            feed_s[0] += time.perf_counter() - t0
            if batch is None:
                return
            yield batch
    return make


def _multihost_worker(rank, world, port, job):
    """One rank of a phase-10 launch: join the gloo group, run each case of ``job`` with
    run_trio_multihost on a mesh of MH_LOCAL copies of cuda:0 at phase 4's config, write
    each case's report and measurements under ``job["out"]``."""
    global torch
    import warnings

    import torch
    import torch.distributed as dist

    from denovo_kmer_tpu_torch.oracle.scalar import format_report
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.parallel import multihost
    from denovo_kmer_tpu_torch.parallel.distributed import initialize_distributed
    from denovo_kmer_tpu_torch.parallel.mesh import make_mesh, table_axis_ici_local

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           timeout=MH_TIMEOUT)
    paths = job["paths"]
    results = {}
    for case in job["cases"]:
        cfg = EngineConfig(**MAIN_CFG, mesh_shape=tuple(case["mesh"]))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mesh = make_mesh(tuple(case["mesh"]), [dev] * MH_LOCAL)
        out = {"mesh": case["mesh"], "table_axis_local": table_axis_ici_local(mesh),
               "warnings": [str(w.message) for w in caught]}
        args = (paths["mom"], paths["dad"], paths["child"], cfg)
        if case.get("refuse"):
            try:
                multihost.run_trio_multihost(*args, require_ici_local=True, mesh=mesh)
                out["refused"] = None
            except RuntimeError as e:
                out["refused"] = str(e)
        kw = {k: case[k] for k in ("feed", "n_passes", "spill_rows", "checkpoint_dir")
              if case.get(k) is not None}
        if case.get("fault"):
            kw["fault"] = tuple(case["fault"])
        feed_s, stage_s = [0.0], {}
        real_stepper = multihost._make_stepper
        multihost._make_stepper = _timed_stepper(real_stepper, feed_s)
        trace = case.get("trace") and rank == 0
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with timed_stages(stage_s), contextlib.ExitStack() as stack:
                prof = (stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])) if trace else None)
                reset_launches()
                t0 = time.perf_counter()
                cands = multihost.run_trio_multihost(*args, mesh=mesh, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_launches()
        finally:
            multihost._make_stepper = real_stepper
        if prof is not None:
            out["device"] = device_time(prof, os.path.join(job["out"], f"{case['name']}_"
                                                           "trace.json"), wall)
        with open(os.path.join(job["out"], f"{case['name']}.rank{rank}.tsv"), "w") as f:
            f.write(format_report(cands, cfg.k))
        out.update({"wall_s": wall, "feed_wait_s": feed_s[0],
                    **{f"{stage}_s": t for stage, t in stage_s.items()},
                    "launches": launches,
                    "peak_device_bytes": torch.cuda.max_memory_allocated()})
        results[case["name"]] = out
        with open(os.path.join(job["out"], f"{job['tag']}.rank{rank}.json"), "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


def _launch_ranks(job, world=MH_RANKS, join_s=MH_JOIN_S):
    """Start ``world`` spawned ranks of ``_multihost_worker`` and watch them under one
    deadline, killing every rank when it passes. → (exit codes, seconds from the start to
    each rank's exit, the measurements each rank wrote)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_multihost_worker, args=(r, world, port, job))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    exits = [None] * world
    try:
        while any(x is None for x in exits):
            if time.perf_counter() - t0 > join_s:
                raise AssertionError(f"a rank outlived {join_s} s; every rank is killed")
            for i, p in enumerate(procs):
                if exits[i] is None and p.exitcode is not None:
                    exits[i] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    measured = []
    for r in range(world):
        path = os.path.join(job["out"], f"{job['tag']}.rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                measured.append(json.load(f))
        else:
            measured.append({})
    return [p.exitcode for p in procs], exits, measured


def depth_cut_trio(work, main, n_reads):
    """The first ``n_reads`` reads of each phase-4 sample as BAMs of their own, with the
    report of their numpy reference at phase 4's config. → {"paths", "report", "batches"
    (all three samples')}."""
    from denovo_kmer_tpu_torch.config import EngineConfig

    cfg = EngineConfig(**MAIN_CFG)
    out = os.path.join(work, f"first{n_reads}")
    os.makedirs(out, exist_ok=True)
    paths = {}
    for name, (pos, rev, codes) in main["samples"].items():
        paths[name] = os.path.join(out, f"{name}.bam")
        write_bam(paths[name], name, codes[:n_reads], pos[:n_reads], rev[:n_reads],
                  GENOME_LEN)
    ref = references({name: (codes[:n_reads], K)
                      for name, (_, _, codes) in main["samples"].items()})
    return {"paths": paths, "report": report_text(reference_candidates(ref, cfg), K),
            "batches": 3 * -(-n_reads // cfg.batch_reads)}


def phase_multihost(work, main):
    """run_trio_multihost in 2 spawned processes (gloo named explicitly), each rank on four
    copies of cuda:0, at phase 4's config on the first ``MH_READS`` reads of each of its
    samples (``depth_cut_trio``): (a) a 2x4 mesh, stripe feed (reads
    axis across the ranks, table axis inside each), traced on rank 0; (b) the range feed;
    (c) a (1,8) mesh whose route all_to_all crosses the ranks (warns; require_ici_local
    refuses it); (d) 2 re-decode passes, and 2 passes through the per-shard device store;
    (e) child rank 1 killed after 2 batches with a checkpoint directory: the survivor
    exits non-zero within the group's timeout, and a relaunch loads both parents' npz
    checkpoints and builds only the child. Every report, on every rank, equals the numpy
    reference's; every trio launches the extraction 4 batches x 3 samples x 4 local shards
    a rank."""
    out_dir = os.path.join(work, "multihost")
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    mesh = list(MESH)
    cases = [
        {"name": "a_stripe_2x4", "mesh": mesh, "feed": "stripe", "trace": True},
        {"name": "b_range_2x4", "mesh": mesh, "feed": "range"},
        {"name": "c_stripe_1x8", "mesh": [1, MESH[0] * MESH[1]], "feed": "stripe",
         "refuse": True},
        {"name": "d_passes_2", "mesh": mesh, "feed": "range", "n_passes": MH_SPILL_PASSES},
        {"name": "d_spill_2", "mesh": mesh, "feed": "range", "n_passes": MH_SPILL_PASSES,
         "spill_rows": MH_SPILL_ROWS},
    ]
    trio = depth_cut_trio(work, main, MH_READS)
    base = {"paths": trio["paths"], "out": out_dir}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    codes, exits, measured = _launch_ranks({**base, "tag": "cases", "cases": cases})
    if codes != [0] * MH_RANKS:
        raise AssertionError(f"multi-process cases: rank exit codes {codes}")
    fault = {"name": "e_fault", "mesh": mesh, "feed": "range", "checkpoint_dir": ckpt,
             "fault": ["child", 1, 2]}
    codes_f, exits_f, _ = _launch_ranks({**base, "tag": "fault", "cases": [fault]})
    if codes_f[1] != 17 or codes_f[0] == 0:
        raise AssertionError(f"fault run: rank exit codes {codes_f} (want 17 and a "
                             "non-zero survivor)")
    lag = exits_f[0] - exits_f[1]
    if lag > MH_TIMEOUT:
        raise AssertionError(f"the survivor exited {lag:.1f} s after rank 1 died, past the "
                             f"group's {MH_TIMEOUT} s timeout")
    saved = sorted(os.listdir(ckpt))
    if saved != ["dad.table.npz", "mom.table.npz"]:
        raise AssertionError(f"fault run left checkpoints {saved}")
    restart = {"name": "e_restart", "mesh": mesh, "feed": "range", "checkpoint_dir": ckpt}
    codes_r, exits_r, measured_r = _launch_ranks({**base, "tag": "restart",
                                                  "cases": [restart]})
    if codes_r != [0] * MH_RANKS:
        raise AssertionError(f"restart: rank exit codes {codes_r}")
    for r in range(MH_RANKS):
        measured[r].update(measured_r[r])

    batches = trio["batches"] // 3  # one sample's batches
    per_trio = 3 * batches * MH_LOCAL  # extraction launches a rank for one trio
    want_launches = {"a_stripe_2x4": per_trio, "b_range_2x4": per_trio,
                     "c_stripe_1x8": per_trio, "d_passes_2": MH_SPILL_PASSES * per_trio,
                     "d_spill_2": per_trio,
                     "e_restart": batches * MH_LOCAL}  # the parents load from npz
    for case in [*cases, restart]:
        name = case["name"]
        reports = []
        for r in range(MH_RANKS):
            with open(os.path.join(out_dir, f"{name}.rank{r}.tsv")) as f:
                reports.append(f.read())
        if reports != [trio["report"]] * MH_RANKS:
            raise AssertionError(f"multihost {name}: a rank's report differs from the "
                                 "numpy reference's")
        for r in range(MH_RANKS):
            got = measured[r][name]["launches"]
            if {**got, "table_merge": 0} != {"extract_kmers": want_launches[name],
                                              "radix_partition": 0, "block_sort": 0,
                                              "table_merge": 0}:
                raise AssertionError(f"multihost {name} rank {r}: launches {got}, want "
                                     f"{want_launches[name]} extractions")
    for r in range(MH_RANKS):
        a, c = measured[r]["a_stripe_2x4"], measured[r]["c_stripe_1x8"]
        if not a["table_axis_local"] or a["warnings"]:
            raise AssertionError(f"rank {r}: the 2x4 mesh is not local to each rank: {a}")
        if c["table_axis_local"] or not any("cannot fit inside one locality domain" in w
                                            for w in c["warnings"]):
            raise AssertionError(f"rank {r}: the (1,8) mesh did not warn: {c['warnings']}")
        if "table axis spans locality domains" not in (c["refused"] or ""):
            raise AssertionError(f"rank {r}: require_ici_local gave {c['refused']!r}")
    out = {"phase": "multihost", "power": power_line(), "ranks": MH_RANKS,
           "backend": "gloo", "local_devices": f"cuda:0 x {MH_LOCAL}",
           "config": MAIN_CFG, "reads_per_sample": MH_READS, "timeout_s": MH_TIMEOUT,
           "spill_rows": MH_SPILL_ROWS,
           "launch_s": {"cases": exits, "fault": exits_f, "restart": exits_r},
           "fault": {"exit_codes": codes_f, "survivor_lag_s": lag, "checkpoints": saved},
           "phase4_wall_s": main["wall_s"],
           "cases": {case["name"]: {f"rank{r}": measured[r][case["name"]]
                                    for r in range(MH_RANKS)}
                     for case in [*cases, restart]}}
    emit(out)
    return out


def _table_reference(paths):
    """The numpy union of ``count`` checkpoints: sorted uint64 k-mer values and summed
    counts."""
    vals, counts = [], []
    for path in paths:
        keys, c, _meta = _npz(path)
        v = np.zeros(keys.shape[0], np.uint64)
        for w in range(keys.shape[1]):
            v = (v << np.uint64(32)) | keys[:, w].astype(np.uint64)
        vals.append(v)
        counts.append(c.astype(np.int64))
    v, c = np.concatenate(vals), np.concatenate(counts)
    uniq, inv = np.unique(v, return_inverse=True)
    return uniq, np.bincount(inv, weights=c).astype(np.int64)


def _decode_values(vals, k):
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    codes = ((vals[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    letters = np.frombuffer(b"ACGT", np.uint8)[codes]
    return [row.tobytes().decode() for row in letters]


def phase_table_tools(work, main):
    """`merge` of phase 6's two `count` checkpoints on the card, then `stats`, `histo`
    and `dump` of the merged table, each equal to the numpy union of the two tables; then
    `doctor --mesh 1x1 --probe-feed` on phase 4's child BAM (its lines and its verdict)."""
    from denovo_kmer_tpu_torch.config import EngineConfig

    cfg = EngineConfig(**MAIN_CFG)
    flags = [*cli_flags(cfg), "--device", "cuda"]
    parents = [os.path.join(work, f"{name}.npz") for name in ("mom", "dad")]
    merged = os.path.join(work, "parents_merged.npz")
    text, wall, launches = run_counted(lambda: _cli(["merge", *parents, "-o", merged,
                                                     *flags]))
    vals, counts = _table_reference(parents)
    keys, got_counts, meta = _npz(merged)
    got_vals = _table_reference([merged])[0]
    if not (np.array_equal(got_vals, vals) and np.array_equal(got_counts, counts)):
        raise AssertionError("merge: the merged table differs from the numpy union")
    if text != f"{merged}\t{len(vals)} uniques\n":
        raise AssertionError(f"merge printed {text!r}")
    out = {"merge": {"wall_s": wall, "n": int(meta["n"]), "launches": launches}}
    t0 = time.perf_counter()
    stats = _cli(["stats", merged, *flags])
    want = (f"Unique:    {int((counts == 1).sum())}\nDistinct:  {len(vals)}\n"
            f"Total:     {int(counts.sum())}\nMax_count: {int(counts.max())}\n")
    if stats != want:
        raise AssertionError(f"stats: {stats!r} != {want!r}")
    histo = _cli(["histo", merged, "--high", "50", *flags])
    hist = np.bincount(np.minimum(counts, 50), minlength=51)
    want = "".join(f"{c}\t{int(hist[c])}\n" for c in range(1, 51) if hist[c] or c == 50)
    if histo != want:
        raise AssertionError("histo differs from the numpy spectrum")
    dump_path = os.path.join(work, "parents_merged.tsv")
    _cli(["dump", merged, "-o", dump_path, *flags])
    with open(dump_path) as f:
        dump = f.read()
    want = "".join(f"{s_}\t{int(c)}\n" for s_, c in zip(_decode_values(vals, cfg.k), counts))
    if dump != want:
        raise AssertionError("dump differs from the numpy table")
    out["stats_histo_dump_s"] = time.perf_counter() - t0
    from denovo_kmer_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["doctor", "--mesh", "1x1", "--probe-feed", main["paths"]["child"],
                       "--device", "cuda"])
    lines = buf.getvalue().splitlines()
    if rc not in (0, 1) or not any(ln.startswith("feed probe") for ln in lines) or not any(
            ln.startswith("torch") for ln in lines):
        raise AssertionError(f"doctor --probe-feed exited {rc}: {lines}")
    out["doctor"] = {"exit": rc, "lines": lines}
    emit({"phase": "table_tools", **out})
    return out


# ---------------------------------------------------------------------------------------
# phase 11: the JAX package's library surface, on phase 4's BAMs and config
# ---------------------------------------------------------------------------------------

def _tuples(cands):
    """(value, child, mom, dad) tuples of ``Candidates``, as TrioResult.candidates."""
    from denovo_kmer_tpu_torch.oracle.scalar import words_to_kmer_value
    from denovo_kmer_tpu_torch.pipeline import _candidate_parts

    keys, cc, mc, dc = _candidate_parts(cands)
    return [(words_to_kmer_value(keys[i]), int(cc[i]), int(mc[i]), int(dc[i]))
            for i in range(keys.shape[0])]


def _same_tensors(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def phase_library(main):
    """The library calls of the JAX package on the card at phase 4's width: (a) the
    standalone extraction on one child batch at k = 31 and 41, and not canonical, against
    the plain version (one launch a call, timed); (b) build_sample_table with a
    SampleTableBuilder step equals phase 4's mom table; (c) ScoringTableBuilder.build (the
    compacting child build) and call_from_score give phase 4's candidates; (d) on the final
    window of the child, with K = 1: fused_flush_call overflows in extract_candidates,
    fused_call_candidates gives phase 4's candidates, unpack_fused reads (c)'s n_unique and
    n_child_unique; (e) ingest_batch and merge_score_tables on the card equal the CPU;
    (f) the public constructors without a device allocate on the card."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.prefetch import as_int32_tensor
    from denovo_kmer_tpu_torch.ops import extract_fast, fused, score, spill, stream, table
    from denovo_kmer_tpu_torch.ops.extract import extract_canonical_kmers
    from denovo_kmer_tpu_torch.pipeline import (
        SampleTableBuilder,
        ScoringTableBuilder,
        _fold_placed,
        build_sample_table,
        packed_batches,
    )
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    cfg = EngineConfig(**MAIN_CFG)
    dev = torch.device("cuda")
    paths, ref, want = main["paths"], main["ref"], main["candidates"]
    out, wall, launches = {"phase": "library"}, {}, {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        launches[name] = read_launches()
        return res

    # (a) one full child batch (it holds Ns), its validity words on the card
    t0 = time.perf_counter()
    batch = next(iter(packed_batches(paths["child"], cfg)))
    words = as_int32_tensor(batch.words).to(dev)
    vwords = as_int32_tensor(batch.vwords).to(dev)
    B, Lw = words.shape
    cases = []
    for k, canonical in ((K, True), (41, True), (K, False)):
        args = (words, vwords, k, cfg.max_read_len, canonical)
        name = f"extract_fast_k{k}" + ("" if canonical else "_forward")
        kmers, valid = counted(name, lambda: extract_fast.extract_canonical_kmers_fast(*args))
        if launches[name]["extract_kmers"] != 1:
            raise AssertionError(f"{name}: {launches[name]} launches, 1 extraction expected")
        pk, pv = extract_canonical_kmers(*args)
        if not torch.equal(valid, pv):
            raise AssertionError(f"{name}: valid differs from the plain version")
        err = int((kmers[pv] - pk[pv]).abs().max()) if pv.any() else 0
        if err:
            raise AssertionError(f"{name}: keys differ at valid windows, max_abs_err={err}")
        nbytes, ops = extraction_bytes_ops(B, Lw, k, cfg.max_read_len, canonical, True)
        bound_ms, bound_by = bound(nbytes, ops)
        cases.append(dict(
            k=k, canonical=canonical, B=B, windows=int(pv.numel()), valid=int(pv.sum()),
            max_abs_err=err, launches=launches[name]["extract_kmers"],
            # keys of invalid windows are unspecified; how many differ is reported
            invalid_keys_differing=int((kmers != pk).any(dim=-1)[~pv].sum()),
            ms=cuda_ms(lambda: extract_fast.extract_canonical_kmers_fast(*args)),
            plain_ms=cuda_ms(lambda: extract_canonical_kmers(*args)),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops))
        del kmers, valid, pk, pv
    out["extract_fast"] = cases
    wall["extract_fast_all"] = time.perf_counter() - t0

    # (b) build_sample_table with a builder as its step, (c) the compacting child build
    mom = counted("build_sample_table_step", lambda: build_sample_table(
        paths["mom"], cfg, step=SampleTableBuilder(cfg)))
    n_mom = check_table(mom, ref["mom"][0], ref["mom"][1], ref["mom"][2],
                        cfg.table_capacity, "mom (build_sample_table step=)")
    dad = counted("build_dad", lambda: build_sample_table(paths["dad"], cfg))
    scored = counted("scoring_build", lambda: ScoringTableBuilder(cfg).build(
        mom, dad, packed_batches(paths["child"], cfg)))
    got = _tuples(score.call_from_score(scored, cfg.tau_parent, cfg.min_child_count))
    if got != want:
        raise AssertionError(f"ScoringTableBuilder.build: {len(got)} candidates, phase 4 "
                             f"{len(want)}")
    n_union = int(scored.n)
    n_child = int((scored.counts[:n_union] >= 1).sum())
    for name, n_batches in (("build_sample_table_step", main["batches"] // 3),
                            ("scoring_build", main["batches"] // 3)):
        if launches[name]["extract_kmers"] != n_batches:
            raise AssertionError(f"{name}: {launches[name]} launches for {n_batches} batches")

    # (d) the final window of the child's fused lane, with a capacity of one candidate
    def final_window():
        lane = ScoringTableBuilder(cfg).call_lane(mom, dad)
        _fold_placed(packed_batches(paths["child"], cfg), cfg, dev, [lane], Metrics())
        return lane

    lane = counted("final_window", final_window)
    tab = lane.state[0]
    args = (lane.acc, tab, cfg.tau_parent, cfg.min_child_count)
    t0 = time.perf_counter()
    packed = fused.fused_flush_call(*args, max_candidates=1)
    try:
        fused.extract_candidates(packed)
        raise AssertionError("extract_candidates took more candidates than K = 1")
    except fused.CandidateOverflowError:
        pass
    head = fused.unpack_fused(packed)
    if (head.n_cand, head.n_unique, head.n_child_unique) != (len(want), n_union, n_child):
        raise AssertionError(f"unpack_fused read {head[:3]}, the compacting build "
                             f"{(len(want), n_union, n_child)}")
    if _tuples(fused.fused_call_candidates(*args, max_candidates=1)) != want:
        raise AssertionError("fused_call_candidates differs from phase 4's candidates")
    wall["fused_protocol"] = time.perf_counter() - t0
    del lane, packed, tab, args

    # (e) the same calls on the card and on the CPU
    t0 = time.perf_counter()
    kmers, valid = extract_fast.extract_canonical_kmers_fast(words, vwords, K,
                                                             cfg.max_read_len)
    on_card = table.ingest_batch(mom, kmers, valid, 1 << 22)
    on_cpu = table.ingest_batch(table.KmerTable(*(t.cpu() for t in mom)), kmers.cpu(),
                                valid.cpu(), 1 << 22)
    if not _same_tensors(on_card, on_cpu):
        raise AssertionError("ingest_batch: the card and the CPU differ")
    card_vs_cpu = {"ingest_batch_n": int(on_card.n)}
    del kmers, valid, on_card, on_cpu
    scored_cpu = score.ScoreTable(*(t.cpu() for t in scored))
    for cap in (cfg.table_capacity, n_union // 2):
        on_card = score.merge_score_tables(scored, scored, cap)
        on_cpu = score.merge_score_tables(scored_cpu, scored_cpu, cap)
        if not _same_tensors(on_card, on_cpu):
            raise AssertionError(f"merge_score_tables at capacity {cap}: the card and the CPU "
                                 "differ")
        card_vs_cpu[f"merge_score_tables_n_at_{cap}"] = int(on_card.n)
    if card_vs_cpu[f"merge_score_tables_n_at_{n_union // 2}"] <= n_union // 2:
        raise AssertionError("merge_score_tables: the overflow did not stick")
    del on_card, on_cpu, scored_cpu
    wall["card_vs_cpu"] = time.perf_counter() - t0

    # (f) constructors without a device
    zeros = np.zeros((8, 2), np.uint32)
    made = {
        "empty_table": table.empty_table(8, 2).keys,
        "table_from_numpy": table.table_from_numpy(zeros, zeros[:, 0], 0).keys,
        "empty_score_table": score.empty_score_table(8, 2).keys,
        "score_table_from_numpy": score.score_table_from_numpy(zeros, zeros[:, 0],
                                                               zeros[:, 0], 0).keys,
        "empty_accumulator": stream.empty_accumulator(8, 2).kmers,
        "empty_pass_store": spill.empty_pass_store(2, 8, 2).rows,
    }
    out["default_device"] = {name: str(t.device) for name, t in made.items()}
    if any(t.device.type != "cuda" for t in made.values()):
        raise AssertionError(f"a constructor left the card: {out['default_device']}")

    out.update(mom_n=n_mom, union_n=n_union, child_n=n_child, candidates=len(want),
               card_vs_cpu=card_vs_cpu, launches=launches, wall_s=wall)
    emit(out)
    return out


# ---------------------------------------------------------------------------------------
# phase 12: the main path at a real size, a chr20-length 30x trio
# ---------------------------------------------------------------------------------------

SCALE_SAMPLES = ("mom", "dad", "child")
SCALE_CAPACITY = 1 << 28  # the next power of two above 1.15 x ~128M uniques a sample
SCALE_SPILL_CAPACITY = 1 << 26  # >= 1.15 x 128M / 4 passes
SCALE_PASSES = 4
SCALE_SPILL_SLACK = 1.10  # --spill-rows: 1.10 x the largest sample's valid windows / passes
SCALE_BUCKETS = 64  # hash buckets of the numpy reference
SCALE_FLAGS = ["-k", str(K), "--max-read-len", "160", "--batch-reads", "16384",
               "--accum-batches", "auto", "--device", "cuda"]


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """A trio at a real size, made from ``seed`` with numpy: a uniform random genome; two
    haplotypes a parent, each with substitution SNVs at ``het_rate`` drawn independently;
    the child is mom's haplotype 0 with ``dnms`` de novo SNVs (at sites where no parental
    haplotype varies) and dad's haplotype 0. Each sample has ``coverage`` x genome_len /
    READ_LEN reads, each from one of its two haplotypes at random, half of them reverse
    strand (stored in reference orientation, as an aligner stores them), with substitution
    errors at ``err_rate`` and Ns at ``n_rate`` a base. Reads are drawn in chunks of
    ``chunk_reads``, each from its own seed, so any worker can make any chunk."""

    genome_len: int = 64_444_167  # GRCh38 chr20
    coverage: int = 30
    het_rate: float = 1e-3
    dnms: int = 100
    err_rate: float = 1e-3
    n_rate: float = 1e-3
    chunk_reads: int = 100_000
    seed: int = 0
    ref_name: str = "chr20"

    @property
    def reads(self) -> int:
        return -(-self.coverage * self.genome_len // READ_LEN)

    @property
    def chunks(self) -> int:
        return -(-self.reads // self.chunk_reads)


def _hap_path(work, sample, h):
    return os.path.join(work, f"{sample}.hap{h}.npy")


def scale_haplotypes(spec, work):
    """Write each sample's two haplotypes to ``work`` (``{sample}.hap{h}.npy``). → (the
    sorted de novo positions, the child's maternal haplotype)."""
    rng = np.random.default_rng([spec.seed, 12])
    L = spec.genome_len
    genome = rng.integers(0, 4, L, dtype=np.uint8)
    varies = np.zeros(L, bool)
    haps = {}
    for parent in ("mom", "dad"):
        for h in (0, 1):
            hap = genome.copy()
            pos = np.unique(rng.integers(0, L, rng.binomial(L, spec.het_rate)))
            hap[pos] = (hap[pos] + rng.integers(1, 4, pos.size, dtype=np.uint8)) % 4
            varies[pos] = True
            haps[parent, h] = hap
    sites = np.unique(rng.integers(K, L - K, 4 * spec.dnms + 64))
    sites = sites[~varies[sites]]
    dnms = np.sort(rng.choice(sites, spec.dnms, replace=False))
    child0 = haps["mom", 0].copy()
    child0[dnms] = (genome[dnms] + rng.integers(1, 4, spec.dnms, dtype=np.uint8)) % 4
    haps["child", 0], haps["child", 1] = child0, haps["dad", 0]
    for (sample, h), hap in haps.items():
        np.save(_hap_path(work, sample, h), hap)
    return dnms, child0


@functools.lru_cache(maxsize=1)
def _haplotypes(work, sample):
    """A sample's two haplotypes (a worker keeps the last sample's in memory)."""
    return [np.load(_hap_path(work, sample, h)) for h in (0, 1)]


def scale_chunk(spec, work, sample, chunk):
    """Chunk ``chunk`` of ``sample``'s reads: (positions, reverse flags, codes (n, READ_LEN)
    uint8 in reference orientation, 4 = N)."""
    rng = np.random.default_rng([spec.seed, 12, SCALE_SAMPLES.index(sample), chunk])
    n = min(spec.chunk_reads, spec.reads - chunk * spec.chunk_reads)
    which = rng.integers(0, 2, n)
    pos = rng.integers(0, spec.genome_len - READ_LEN + 1, n)
    rev = rng.random(n) < 0.5
    codes = np.empty((n, READ_LEN), np.uint8)
    for h, hap in enumerate(_haplotypes(work, sample)):
        sel = which == h
        codes[sel] = np.lib.stride_tricks.sliding_window_view(hap, READ_LEN)[pos[sel]]
    flat = codes.reshape(-1)
    err = rng.integers(0, flat.size, rng.binomial(flat.size, spec.err_rate))
    flat[err] = (flat[err] + rng.integers(1, 4, err.size, dtype=np.uint8)) % 4
    flat[rng.integers(0, flat.size, rng.binomial(flat.size, spec.n_rate))] = 4
    return pos, rev, codes


_NIBBLE = np.array([1, 2, 4, 8, 15], np.uint8)  # A C G T N as BAM 4-bit codes


def _reg2bin(beg, end):
    """SAMv1 bin of each [beg, end) interval (numpy; io/bam.py's rule)."""
    end = end - 1
    out = np.zeros(beg.shape, np.int64)
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        same = (beg >> shift) == (end >> shift)
        out = np.where(same, first + (beg >> shift), out)
    return out


def bam_chunk_records(tag, digits, first, pos, rev, codes):
    """The BAM records (uncompressed bytes) of a chunk of reads in one fixed layout: name
    ``{tag}{index:0{digits}d}`` for the reads ``first``, ``first+1``, ...; reference 0,
    mapq 60, one M operation, flag 0x10 on reverse reads, sequence ``codes``, no qualities
    (0xFF), no mate. The same bytes as io/bam.BamWriter writes a record."""
    n, L = codes.shape
    nib = _NIBBLE[codes]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    seq = (nib[:, 0::2] << 4) | nib[:, 1::2]
    name_len = len(tag) + digits
    dt = np.dtype([("block_size", "<i4"), ("refid", "<i4"), ("pos", "<i4"),
                   ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"),
                   ("flag", "<u2"), ("l_seq", "<i4"), ("next_refid", "<i4"),
                   ("next_pos", "<i4"), ("tlen", "<i4"), ("name", "u1", (name_len + 1,)),
                   ("cigar", "<u4"), ("seq", "u1", (seq.shape[1],)), ("qual", "u1", (L,))])
    rec = np.zeros(n, dt)
    rec["block_size"] = dt.itemsize - 4
    rec["pos"] = pos
    rec["l_read_name"] = name_len + 1
    rec["mapq"] = 60
    rec["bin"] = _reg2bin(pos, pos + L)
    rec["n_cigar"] = 1
    rec["flag"] = np.where(rev, 0x10, 0)
    rec["l_seq"] = L
    rec["next_refid"] = -1
    rec["next_pos"] = -1
    idx = first + np.arange(n, dtype=np.int64)
    rec["name"][:, :len(tag)] = np.frombuffer(tag.encode(), np.uint8)
    rec["name"][:, len(tag):name_len] = (idx[:, None] // 10 ** np.arange(digits - 1, -1, -1)
                                         % 10 + ord("0"))
    rec["cigar"] = L << 4
    rec["seq"] = seq
    rec["qual"] = 0xFF
    return rec.tobytes()


def bam_header(ref_name, ref_len, text="@HD\tVN:1.6\tSO:unsorted\n"):
    """BAM header bytes (magic, text, one reference), as io/bam.BamWriter writes them."""
    t, nb = text.encode(), ref_name.encode() + b"\x00"
    return (b"BAM\x01" + struct.pack("<i", len(t)) + t + struct.pack("<i", 1)
            + struct.pack("<i", len(nb)) + nb + struct.pack("<i", ref_len))


def bgzf_compress(data, level=1):
    """``data`` as BGZF blocks of io/bgzf.py's size and layout (no EOF marker)."""
    from denovo_kmer_tpu_torch.io.bgzf import MAX_BLOCK_UNCOMPRESSED

    view = memoryview(data)
    out = []
    for at in range(0, len(view), MAX_BLOCK_UNCOMPRESSED):
        block = view[at:at + MAX_BLOCK_UNCOMPRESSED]
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = comp.compress(block) + comp.flush()
        out += [struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 0x42, 0x43, 2,
                            len(cdata) + 25),
                cdata, struct.pack("<II", zlib.crc32(block), len(block))]
    return b"".join(out)


def canonical_rows(codes, k):
    """Host numpy: the canonical k-mer of every N-free window of every row of ``codes``, as
    (m, 1) uint64 values (k <= 32) or (m, 2) uint64 (hi, lo) rows of the 2k-bit value
    (32 < k <= 64; ``window_words``' halves). One pass along the reads, each base shifted
    into the forward and reverse-complement values and the count of bases since the last
    N, 8,192 reads at a time so the pass stays in cache; rows come position by position."""
    block = 8192
    n, L = codes.shape
    P = L - k + 1
    two, one, kk = np.uint64(2), np.int32(1), np.int32(k)
    wide = k > 32
    if wide:  # the top 2k - 64 bits in hi, the low 64 in lo
        hmask, s62 = np.uint64((1 << (2 * k - 64)) - 1), np.uint64(62)
        top = np.uint64(2 * k - 66)
        his = np.empty((P, n), np.uint64)
    else:
        mask, top = np.uint64((1 << 2 * k) - 1), np.uint64(2 * (k - 1))
    vals = np.empty((P, n), np.uint64)
    valid = np.empty((P, n), bool)
    for a in range(0, n, block):
        cb = np.ascontiguousarray(codes[a:a + block].T)
        c = np.minimum(cb, 3).astype(np.uint64)
        rc = (np.uint64(3) - c) << top
        isn = cb == 4
        m = c.shape[1]
        f, r, run = np.zeros(m, np.uint64), np.zeros(m, np.uint64), np.zeros(m, np.int32)
        if wide:
            fh, rh, t = np.zeros(m, np.uint64), np.zeros(m, np.uint64), np.empty(m, np.uint64)
        for j in range(L):
            run += one
            run[isn[j]] = 0
            if j >= k - 1:
                np.greater_equal(run, kk, out=valid[j - k + 1, a:a + block])
            if wide:
                # forward: (fh, f) << 2 | base; reverse complement: (rh, r) >> 2 with the
                # complement entering at the top of rh
                np.right_shift(f, s62, out=t)
                fh <<= two
                fh |= t
                fh &= hmask
                f <<= two
                f |= c[j]
                np.bitwise_and(rh, np.uint64(3), out=t)
                t <<= s62
                r >>= two
                r |= t
                rh >>= two
                rh |= rc[j]
                if j >= k - 1:
                    take = (rh < fh) | ((rh == fh) & (r < f))
                    out_h, out_l = his[j - k + 1, a:a + block], vals[j - k + 1, a:a + block]
                    np.copyto(out_h, fh)
                    np.copyto(out_h, rh, where=take)
                    np.copyto(out_l, f)
                    np.copyto(out_l, r, where=take)
                continue
            f <<= two
            f |= c[j]
            f &= mask
            r >>= two
            r |= rc[j]
            if j >= k - 1:
                np.minimum(f, r, out=vals[j - k + 1, a:a + block])
    if wide:
        return np.stack([his[valid], vals[valid]], axis=1)
    return vals[valid][:, None]


def unique_pairs(hi, lo):
    """The distinct uint64 (hi, lo) pairs, (u, 2), with their counts, in no set order. One
    value sort (several times faster than an argsort) of a 64-bit key whose low bits are the
    row's index and whose high bits are a hash of its pair brings each pair's rows
    together, except where two pairs share the hash's kept bits: the rows of such runs are
    moved behind the others and put in ``lex_order``. Exact."""
    n = hi.shape[0]
    bits = max(int(n - 1).bit_length(), 1)
    key = lo ^ (hi * _MIX)
    key >>= np.uint64(bits)
    key <<= np.uint64(bits)
    key |= np.arange(n, dtype=np.uint64)
    key.sort()
    order = (key & np.uint64((1 << bits) - 1)).astype(np.int64)
    key >>= np.uint64(bits)  # the run: the pair's hash bits
    h, l = hi[order], lo[order]
    del order
    same = (h[1:] == h[:-1]) & (l[1:] == l[:-1])
    mixed = (key[1:] == key[:-1]) & ~same  # a run that holds two pairs
    if mixed.any():
        run = np.concatenate([[0], np.cumsum(key[1:] != key[:-1])])
        odd = np.isin(run, run[1:][mixed])
        sub = lex_order(h[odd], l[odd])
        h = np.concatenate([h[~odd], h[odd][sub]])
        l = np.concatenate([l[~odd], l[odd][sub]])
        same = (h[1:] == h[:-1]) & (l[1:] == l[:-1])
    del key
    at = np.flatnonzero(np.concatenate([[True], ~same])) if n else np.zeros(0, np.int64)
    return np.stack([h[at], l[at]], axis=1), np.diff(np.append(at, n))


def lex_order(hi, lo):
    """Indices that sort uint64 (hi, lo) pairs lexicographically (``np.lexsort((lo, hi))``'s
    order up to ties, a few times faster): an argsort of lo, then stable radix passes over
    the 16-bit digits of hi that are not all zero."""
    order = np.argsort(lo)
    h = hi[order]
    top = int(h.max()) if h.size else 0
    shift = 0
    while top >> shift:
        step = np.argsort(((h >> np.uint64(shift)) & np.uint64(0xFFFF)).astype(np.uint16),
                          kind="stable")
        order, h = order[step], h[step]
        shift += 16
    return order


_MIX = np.uint64(0x9E3779B97F4A7C15)
_MIX_INV = np.uint64(pow(0x9E3779B97F4A7C15, -1, 1 << 64))  # odd: v -> v * _MIX is one to one


def bucket_of(rows, n_buckets):
    """Hash bucket (uint8, n_buckets a power of two <= 256) of each (m, cols) uint64 row: the
    top bits of its first column times ``_MIX`` (the value, or the top word of a two-word
    value, so that a bucket holds whole hi groups)."""
    top = np.uint64(64 - n_buckets.bit_length() + 1)
    return ((rows[:, 0] * _MIX) >> top).astype(np.uint8)


def _chunk_slots(spec, k):
    """Rows a chunk may stage in its sample's shared values buffer (every window)."""
    return spec.chunk_reads * (READ_LEN - k + 1)


def _cols(k):
    """uint64 columns of a k-mer row: the value (k <= 32), or its (hi, lo) halves."""
    return 1 if k <= 32 else 2


def values_bytes(spec, k):
    """Bytes of one sample's shared values buffer at ``k`` (8 B a window a column)."""
    return spec.chunks * _chunk_slots(spec, k) * _cols(k) * 8


@contextlib.contextmanager
def _values(name, spec, k):
    """A sample's shared values buffer (one slot of ``_chunk_slots`` rows a chunk) as a
    uint64 (cols, rows) array, a plane a column; the creator (``scale_counts``) unlinks
    it."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    arr = np.ndarray((_cols(k), spec.chunks * _chunk_slots(spec, k)), np.uint64,
                     buffer=shm.buf)
    try:
        yield arr
    finally:
        del arr
        shm.close()


def scale_chunk_task(spec, work, values, sample, chunk, k, n_buckets, bam=True):
    """A worker's chunk: make its reads (from the haplotypes in ``work``), their BAM records
    as BGZF blocks (``bam``; else b""), and their canonical k-mers grouped by hash bucket
    into the chunk's slot of the sample's shared values buffer ``values``. A one-word k-mer
    (k <= 32) is stored as its hash ``v * _MIX``, sorted, so that each bucket (the hash's
    top bits, ``bucket_of``) is a run found by a search; two-word rows in bucket order. →
    (BGZF bytes, k-mers a bucket, valid windows, seconds a step)."""
    t = [time.perf_counter()]
    pos, rev, codes = scale_chunk(spec, work, sample, chunk)
    t.append(time.perf_counter())
    digits = len(str(spec.reads - 1))
    blob = (bgzf_compress(bam_chunk_records(sample[0], digits, chunk * spec.chunk_reads, pos,
                                            rev, codes)) if bam else b"")
    t.append(time.perf_counter())
    rows = canonical_rows(codes, k)
    del codes
    t.append(time.perf_counter())
    m = rows.shape[0]
    at = chunk * _chunk_slots(spec, k)
    if rows.shape[1] == 1:
        h = rows[:, 0]
        h *= _MIX
        h.sort()
        edges = np.arange(1, n_buckets, dtype=np.uint64) << np.uint64(65 - n_buckets.bit_length())
        counts = np.diff(np.searchsorted(h, edges), prepend=0, append=m)
        t.append(time.perf_counter())
        with _values(values, spec, k) as store:
            store[0, at:at + m] = h
    else:
        bucket = bucket_of(rows, n_buckets)
        order = np.argsort(bucket, kind="stable")
        counts = np.bincount(bucket, minlength=n_buckets)
        t.append(time.perf_counter())
        with _values(values, spec, k) as store:
            for c in range(rows.shape[1]):
                np.take(rows[:, c], order, out=store[c, at:at + m])
    t.append(time.perf_counter())
    seconds = dict(zip(("reads", "bam", "kmers", "buckets", "store"), np.diff(t)))
    return blob, counts, m, seconds


def _bucket_path(work, sample, b, what):
    return os.path.join(work, f"{sample}.b{b}.{what}.npy")


def _in_sorted(a, s):
    """Which values of ``a`` are in the ascending array ``s``."""
    if not s.size:
        return np.zeros(a.shape, bool)
    return s[np.minimum(np.searchsorted(s, a), s.size - 1)] == a


def scale_bucket_task(spec, work, values, sample, b, k, counts):
    """A worker's bucket: the sample's k-mers of bucket ``b`` from every chunk's slot of the
    shared values buffer, counted (``sorted_counts`` of the hashes for one-word k-mers,
    ``unique_pairs`` for two-word rows) and saved to ``work`` (values, not hashes); for the
    child also the bucket's candidates (count >= 2, the CLI's --min-child-count, and absent
    from both parents' bucket ``b``: --tau-parent 0). → {"n": uniques, "windows": their
    count sum[, "cand_keys", "cand_counts"]}."""
    slots = _chunk_slots(spec, k)
    starts = np.cumsum(counts, axis=1) - counts
    with _values(values, spec, k) as store:
        cols = [np.concatenate([plane[c * slots + starts[c, b]:
                                      c * slots + starts[c, b] + counts[c, b]]
                                for c in range(counts.shape[0])]) for plane in store]
    wide = len(cols) == 2
    if wide:
        keys, cnt = unique_pairs(*cols)
        del cols
    else:
        hashes, cnt = sorted_counts(cols.pop())
        keys = (hashes * _MIX_INV)[:, None]
    np.save(_bucket_path(work, sample, b, "keys"), keys)
    np.save(_bucket_path(work, sample, b, "counts"), cnt)
    out = {"n": keys.shape[0], "windows": int(cnt.sum())}
    if sample == "child":
        keep = cnt >= 2
        cand, ccnt = (keys if wide else hashes)[keep], cnt[keep]
        for parent in ("mom", "dad"):
            pk = np.load(_bucket_path(work, parent, b, "keys"))
            # a parent's values were saved in its hashes' ascending order
            seen = _rows_in(cand, pk) if wide else _in_sorted(cand, pk[:, 0] * _MIX)
            cand, ccnt = cand[~seen], ccnt[~seen]
        out["cand_keys"] = cand if wide else (cand * _MIX_INV)[:, None]
        out["cand_counts"] = ccnt
    return out


def scale_trio(spec, work, k=K, n_buckets=SCALE_BUCKETS, workers=None, haplotypes=None,
               pool=None, slots=None):
    """Write the trio's haplotypes (unless ``haplotypes``, ``scale_haplotypes``' result for
    ``work``, says they are there) and BAMs (``work/{sample}.bam``, one reference
    ``spec.ref_name``) and its hash-bucketed numpy reference at ``k`` (``scale_counts``,
    on ``pool`` and ``slots`` where given). → ``scale_counts``' dict with dnms, child_hap
    and seconds["haplotypes"]."""
    t0 = time.perf_counter()
    dnms, child_hap = haplotypes or scale_haplotypes(spec, work)
    t1 = time.perf_counter()
    out = scale_counts(spec, work, work, k, n_buckets, workers, bams=True, pool=pool,
                       slots=slots)
    out["seconds"]["haplotypes"] = t1 - t0
    return dict(out, dnms=dnms, child_hap=child_hap)


def scale_counts(spec, work, out_dir, k, n_buckets=SCALE_BUCKETS, workers=None, bams=False,
                 live=3, nice=0, on_pool=None, pool=None, slots=None):
    """The trio's hash-bucketed numpy reference at ``k`` from the haplotypes in ``work``
    (and, with ``bams``, its BAMs written there) on a spawn process pool: chunk tasks make
    the reads, write their BAM records and put their k-mers, grouped by bucket, into a
    shared memory buffer a sample (``values_bytes``); bucket tasks count each bucket into
    ``out_dir`` (the child's after both parents'). At most ``live`` samples' buffers exist
    at once: a sample's buffer is created once an earlier one is released. The workers run
    at ``nice``; ``on_pool(pool)`` is told of the pool (to cancel it). Given ``pool``, its
    workers run the tasks and it stays open; given ``slots`` (shared memory buffers of at
    least ``values_bytes`` each, made once and so paged in once), a sample takes a free
    one in place of a buffer of its own and ``live`` is their number. → dict(paths (with
    ``bams``), ref {sample: {"n", "windows"}}, candidates [(value, child count, 0, 0)]
    ascending, seconds: chunks (until every chunk is in), buckets (the rest), first_chunk
    (the pool's start and first task), and chunk_task_s (the chunk tasks' seconds by step,
    summed over workers))."""
    from multiprocessing import shared_memory

    from denovo_kmer_tpu_torch.io.bgzf import BGZF_EOF

    t1 = time.perf_counter()
    shms, paths, ref, cands, parts, task_s, first = {}, {}, {}, [], {}, {}, None
    free = None if slots is None else list(slots)
    live = live if slots is None else len(slots)
    try:
        with contextlib.ExitStack() as stack:
            if pool is None:
                pool = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                    workers or os.cpu_count(), mp_context=multiprocessing.get_context("spawn"),
                    initializer=os.nice if nice else None, initargs=(nice,) if nice else ()))
                if on_pool:
                    on_pool(pool)

            def start(sample):
                shms[sample] = (free.pop(0) if free is not None else
                                shared_memory.SharedMemory(create=True,
                                                           size=values_bytes(spec, k)))
                return [pool.submit(scale_chunk_task, spec, work, shms[sample].name, sample,
                                    c, k, n_buckets, bams) for c in range(spec.chunks)]

            def release(sample):
                parts[sample] = [f.result() for f in bucket_futures.pop(sample)]
                shm = shms.pop(sample)
                if free is not None:
                    free.append(shm)
                else:
                    shm.close()
                    shm.unlink()

            chunk_futures = {s: start(s) for s in SCALE_SAMPLES[:live]}
            bucket_futures = {}
            for sample in SCALE_SAMPLES:
                if sample not in chunk_futures:  # the oldest buffer makes room
                    release(next(iter(bucket_futures)))
                    chunk_futures[sample] = start(sample)
                counts, windows = [], 0
                f = open(os.path.join(work, f"{sample}.bam"), "wb") if bams else None
                if f:
                    paths[sample] = f.name
                    f.write(bgzf_compress(bam_header(spec.ref_name, spec.genome_len)))
                for fut in chunk_futures.pop(sample):
                    blob, bcounts, m, sec = fut.result()
                    first = first or time.perf_counter()
                    if f:
                        f.write(blob)
                    counts.append(bcounts)
                    windows += m
                    for key, v in sec.items():
                        task_s[key] = task_s.get(key, 0.0) + v
                if f:
                    f.write(BGZF_EOF)
                    f.close()
                ref[sample] = {"windows": windows}
                if sample == "child":  # its candidates need both parents' buckets
                    for parent in ("mom", "dad"):
                        if parent in bucket_futures:
                            release(parent)
                bucket_futures[sample] = [
                    pool.submit(scale_bucket_task, spec, out_dir, shms[sample].name, sample,
                                b, k, np.stack(counts)) for b in range(n_buckets)]
            t2 = time.perf_counter()
            release("child")
    finally:
        if free is None:
            for shm in shms.values():
                shm.close()
                shm.unlink()
    for sample in SCALE_SAMPLES:
        n, held = (sum(p[key] for p in parts[sample]) for key in ("n", "windows"))
        if held != ref[sample]["windows"]:
            raise AssertionError(f"{sample}: buckets hold {held} of {ref[sample]['windows']} "
                                 "windows")
        ref[sample]["n"] = n
    keys = np.concatenate([p["cand_keys"] for p in parts["child"]])
    cnt = np.concatenate([p["cand_counts"] for p in parts["child"]])
    order = np.lexsort(keys.T[::-1])
    for row, c in zip(keys[order], cnt[order]):
        v = int(row[0]) if len(row) == 1 else (int(row[0]) << 64) | int(row[1])
        cands.append((v, int(c), 0, 0))
    return dict(paths=paths, ref=ref, candidates=cands,
                seconds={"chunks": t2 - t1, "buckets": time.perf_counter() - t2,
                         "first_chunk": first - t1, "chunk_task_s": task_s})


@contextlib.contextmanager
def scale_slots(spec, ks, share=None):
    """Shared k-mer buffers for ``scale_counts``' ``slots``: each of the largest
    ``values_bytes`` over ``ks``, as many (at most 3, one a sample) as fit ``share``
    (``SWEEP_SHM_SHARE``) of the host's available memory; it fails before any is made if
    not even one does. Unlinked on exit."""
    from multiprocessing import shared_memory

    host = host_memory()
    size = max(values_bytes(spec, k) for k in ks)
    live = min(3, int((share or SWEEP_SHM_SHARE) * host["available"]) // size)
    print(f"scale references k={','.join(map(str, ks))}: host RAM {host['total'] / 1e9:.1f} "
          f"GB, {host['available'] / 1e9:.1f} GB available; {size / 1e9:.1f} GB of k-mer "
          f"values a sample at most, {live} buffers", file=sys.stderr, flush=True)
    if live < 1:
        raise AssertionError(
            f"the references need {size / 1e9:.1f} GB of shared memory a sample, more than "
            f"{share or SWEEP_SHM_SHARE:.0%} of the host's {host['available'] / 1e9:.1f} GB "
            "available: refusing to run into swap")
    slots = []
    try:
        for _ in range(live):
            slots.append(shared_memory.SharedMemory(create=True, size=size))
        yield slots
    finally:
        for shm in slots:
            shm.close()
            shm.unlink()


def scale_reference_table(work, sample, n_buckets=SCALE_BUCKETS):
    """A sample's whole reference table from its bucket files: (keys (m, cols) uint64
    ascending, counts)."""
    keys = np.concatenate([np.load(_bucket_path(work, sample, b, "keys"))
                           for b in range(n_buckets)])
    cnt = np.concatenate([np.load(_bucket_path(work, sample, b, "counts"))
                          for b in range(n_buckets)])
    order = np.lexsort(keys.T[::-1])
    return keys[order], cnt[order]


def scale_lookup(work, sample, rows, n_buckets=SCALE_BUCKETS):
    """The reference counts (0 where absent) of (m, cols) uint64 k-mer rows in a sample's
    bucket files."""
    out = np.zeros(rows.shape[0], np.int64)
    for i, b in enumerate(bucket_of(rows, n_buckets)):
        keys = np.load(_bucket_path(work, sample, b, "keys"))
        hit = np.nonzero((keys == rows[i]).all(axis=1))[0]
        if hit.size:
            out[i] = np.load(_bucket_path(work, sample, b, "counts"))[hit[0]]
    return out


def dnm_evidence(work, child_hap, site, k=K, n_buckets=SCALE_BUCKETS):
    """Reference counts (child, mom, dad) of the child's canonical k-mers over a de novo
    site: why the trio call did or did not report it (a k-mer is a candidate only with
    child count >= 2 and absent from both parents)."""
    window = child_hap[site - k + 1:site + k][None, :]
    rows = canonical_rows(window, k)
    return {s: scale_lookup(work, s, rows, n_buckets).tolist() for s in SCALE_SAMPLES}


def report_text(candidates, k):
    """The candidate TSV (SPEC_SEMANTICS §7) of (value, child, mom, dad) tuples."""
    lines = ["#kmer\tchild_count\tmom_count\tdad_count"]
    for v, c, m, d in candidates:
        kmer = "".join("ACGT"[(v >> 2 * (k - 1 - j)) & 3] for j in range(k))
        lines.append(f"{kmer}\t{c}\t{m}\t{d}")
    return "\n".join(lines) + "\n"


class TableSteps:
    """Device seconds (CUDA events), calls, rows and memory of the table steps of a run
    (the flushes, the seed, the fused call, the spill's partition and pass calls), taken
    by wrapping them, with each call's key words W and staging slots (which name a sweep's
    lane). Each call's device bytes beyond its inputs and output are taken from the
    allocator's peak, which is reset at each call; ``peak`` keeps the run's overall peak
    across those resets."""

    def __init__(self):
        self.calls = {}
        self.peak = 0

    def _wrap(self, name, real, rows_of):
        def wrapped(*a, **kw):
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            res = real(*a, **kw)
            end.record()
            extra = torch.cuda.max_memory_allocated() - base - _new_bytes(res, a)
            acc = a[0] if hasattr(a[0], "slots") else None
            table = a[1] if acc is not None and len(a) > 1 else a[0]
            words = (acc.kmers if acc is not None else table.keys).shape[1]
            self.calls.setdefault(name, []).append(
                (start, end, rows_of(*a, **kw), extra, words,
                 None if acc is None else acc.slots))
            return res
        return wrapped

    @contextlib.contextmanager
    def patched(self):
        from denovo_kmer_tpu_torch import pipeline
        from denovo_kmer_tpu_torch.ops import score, spill

        def flush_rows(acc, tab, *_a, **_k):
            return tab.capacity + acc.slots

        def seed_rows(mom, dad, *_a, **_k):
            return mom.capacity + dad.capacity

        def window_rows(acc, *_a, **_k):
            return acc.slots

        def call_rows(tab, *_a, **_k):
            return tab.capacity

        targets = [(pipeline, "flush", "flush", flush_rows),
                   (pipeline, "flush_score", "flush_score", flush_rows),
                   (spill, "flush", "pass_flush", flush_rows),
                   (score, "flush_score", "pass_flush_score", flush_rows),
                   (pipeline, "seed_score_table", "seed", seed_rows),
                   (pipeline, "fused_call_full", "fused_call", flush_rows),
                   (pipeline, "call_from_score", "pass_call", call_rows),
                   (spill, "partition_window", "partition", window_rows)]
        reals = [(mod, attr, getattr(mod, attr)) for mod, attr, _n, _r in targets]
        for (mod, attr, name, rows_of), (_m, _a, real) in zip(targets, reals):
            setattr(mod, attr, self._wrap(name, real, rows_of))
        try:
            yield self
        finally:
            for mod, attr, real in reals:
                setattr(mod, attr, real)

    @staticmethod
    def _sum(calls):
        return {"calls": len(calls),
                "device_s": sum(c[0].elapsed_time(c[1]) for c in calls) / 1e3,
                "rows": sum(c[2] for c in calls),
                "max_bytes_per_row": max(c[3] / max(c[2], 1) for c in calls)}

    def summary(self):
        """{step: {calls, device_s, rows, max_bytes_per_row, by_words: {W: the same}}}
        (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, calls in self.calls.items():
            out[name] = self._sum(calls)
            out[name]["by_words"] = {w: self._sum([c for c in calls if c[4] == w])
                                     for w in sorted({c[4] for c in calls})}
        return out

    def by_lane(self, lane_of_slots, seed_order):
        """{k: {step: {calls, device_s, rows, max_bytes_per_row}}}: a call with staging
        slots goes to the lane ``lane_of_slots`` names; the seeds, which have none, go to
        ``seed_order``'s lanes in turn (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, calls in self.calls.items():
            lanes = ([seed_order[i] for i in range(len(calls))] if name == "seed"
                     else [lane_of_slots[c[5]] for c in calls])
            for k in dict.fromkeys(lanes):
                out.setdefault(k, {})[name] = self._sum(
                    [c for c, lane in zip(calls, lanes) if lane == k])
        return out

    #: the auto model's kind of each step (``cli.STEP_BYTES_PER_ROW``)
    KINDS = {"seed": "seed", "fused_call": "call"}

    def over_model(self, model):
        """The calls holding more device bytes a row than ``model[W][kind]``: [(step, W,
        bytes a row, the model's)]."""
        out = []
        for name, calls in self.calls.items():
            for c in calls:
                limit = model[c[4]][self.KINDS.get(name, "flush")]
                if c[3] / max(c[2], 1) > limit:
                    out.append((name, c[4], c[3] / max(c[2], 1), limit))
        return out


def _new_bytes(res, args):
    """Device bytes of the tensors a step returns that none of its arguments holds (its
    output tables; a staging buffer handed back is not new)."""
    seen = set()

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)

    held = {t.untyped_storage().data_ptr() for t in tensors(list(args)) if t.is_cuda}
    total = 0
    for t in tensors(res):
        ptr = t.untyped_storage().data_ptr()
        if t.is_cuda and ptr not in held and ptr not in seen:
            seen.add(ptr)
            total += t.untyped_storage().nbytes()
    return total


@contextlib.contextmanager
def captured_metrics(out):
    """Every ``Metrics`` made while inside is appended to ``out`` (the CLI makes its own)."""
    from denovo_kmer_tpu_torch.utils import metrics

    real = metrics.Metrics

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            out.append(self)

    metrics.Metrics = Recorded
    try:
        yield out
    finally:
        metrics.Metrics = real


def _cli_run(argv):
    """The CLI in this process: → (stdout, stderr); a non-zero exit fails."""
    from denovo_kmer_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def scale_cli(argv, trace=None, lanes=None):
    """A CLI run (`call` or `sweep`) on the card with every launch count set to 0 just
    before and read just after, its table steps timed (``TableSteps``), optionally under a
    torch.profiler trace written to ``trace``. → dict of the run's numbers; ``tables_n``
    is keyed by k for a sweep, by None for a call. ``lanes(auto batches)`` → (staging
    slots → k, the ks in seeding order) splits a sweep's table steps by k (``by_lane``);
    ``over_model`` lists each step call above the auto model's bytes a row for its step
    and W."""
    from denovo_kmer_tpu_torch import cli
    from denovo_kmer_tpu_torch.io.native import NativeBamFeeder

    steps, metrics = TableSteps(), []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    prof = (torch.profiler.profile(activities=acts) if trace
            else contextlib.nullcontext())
    with prof, steps.patched(), captured_metrics(metrics):
        reset_launches()
        NativeBamFeeder.batches = 0
        t0 = time.perf_counter()
        _, err = _cli_run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        native_batches = NativeBamFeeder.batches
    peak = max(steps.peak, torch.cuda.max_memory_allocated())
    auto = re.search(r"accum auto: (\d+) batches/window \((\d+) staging rows; modelled peak "
                     r"([0-9.]+) GB", err)
    uniq = re.findall(r"(?:k=(\d+): [^\n]*)?uniques mom=(\d+) dad=(\d+) child=(\d+)", err)
    m = metrics[0]
    return {"argv": argv[7:], "wall_s": wall, "seconds": dict(m.seconds),
            "counters": dict(m.counters), "feed_wait_s": m.seconds.get("feed_wait", 0.0),
            "launches": launches, "native_feeder_batches": native_batches,
            "peak_device_bytes": peak, "auto_batches": int(auto.group(1)),
            "auto_window_rows": int(auto.group(2)),
            "auto_modelled_peak_bytes": float(auto.group(3)) * 1e9,
            "tables_n": {int(k) if k else None: dict(zip(("mom", "dad", "child"),
                                                           map(int, n)))
                         for k, *n in uniq},
            "accum_line": re.search(r"accum auto: [^\n]*", err).group(0),
            "steps": steps.summary(),
            "by_lane": steps.by_lane(*lanes(int(auto.group(1)))) if lanes else None,
            "over_model": steps.over_model(cli.STEP_BYTES_PER_ROW),
            "device": device_time(prof, trace, wall) if trace else None}


def phase_scale(work, spec=ScaleSpec(), early=None):
    """Phase 12: the main path at a real size. A chr20-length 30x trio (``ScaleSpec``) is
    written as BAMs with its hash-bucketed numpy reference; `call` runs on it through the
    CLI on the card (a) single-pass at table capacity 2^28 and (b) as the 4-pass
    device-store spill at 2^26, both with --accum-batches auto. (a)'s report must equal the
    reference's candidates and its tables_n the reference's unique counts, every planted
    de novo SNV must lie under a candidate unless the reference shows each k-mer over it
    seen fewer than twice in the child or seen in a parent, (b)'s report must equal (a)'s,
    each run's extraction must launch once a batch (and the partition once a staging
    window in (b)), and no table step may hold more device bytes a row than the CLI's auto
    model counts for its W. The BAMs and haplotypes stay in ``work/scale`` for phase 13;
    the reference's bucket files go. With ``early`` (``ScaleJobs``) the trio and its
    reference are the background job's, waited for here. → {"dir", "data", "report",
    "runs": {name: {"launches"}}}."""
    t0 = time.perf_counter()
    if early is None:
        sdir = os.path.join(work, "scale")
        os.makedirs(sdir)
        data = scale_trio(spec, sdir)
    else:
        sdir, data = early.sdir, early.data()
    t1 = time.perf_counter()
    want = report_text(data["candidates"], K)
    batches = 3 * -(-spec.reads // 16384)
    mem = torch.cuda.get_device_properties(0).total_memory
    runs = {}
    for name, flags, trace in (
            ("a", ["--table-capacity", str(SCALE_CAPACITY)],
             os.path.join(sdir, "scale_trace.json")),
            ("b", ["--table-capacity", str(SCALE_SPILL_CAPACITY), "--passes",
                   str(SCALE_PASSES), "--spill-rows",
                   str(-(-int(SCALE_SPILL_SLACK * max(r["windows"] for r in
                                                      data["ref"].values()))
                         // SCALE_PASSES))], None)):
        out = os.path.join(sdir, f"{name}.tsv")
        paths = data["paths"]
        run = runs[name] = scale_cli(["call", "--mom", paths["mom"], "--dad", paths["dad"],
                                      "--child", paths["child"], *SCALE_FLAGS, *flags,
                                      "-o", out], trace)
        run["tables_n"] = run["tables_n"][None]
        with open(out) as f:
            report = f.read()
        run["candidates"] = report.count("\n") - 1
        if report != want:
            raise AssertionError(f"run ({name}): the report differs from the numpy "
                                 f"reference's {len(data['candidates'])} candidates "
                                 f"({run['candidates']} rows)")
        ref_n = {s: r["n"] for s, r in data["ref"].items()}
        if run["tables_n"] != ref_n:
            raise AssertionError(f"run ({name}): tables_n {run['tables_n']} != {ref_n}")
        if run["launches"]["extract_kmers"] != batches or run["native_feeder_batches"] != batches:
            raise AssertionError(f"run ({name}): {run['launches']} launches, "
                                 f"{run['native_feeder_batches']} feeder batches for "
                                 f"{batches} batches")
        windows = 3 * -(-(batches // 3) // run["auto_batches"])
        want_part = windows if name == "b" else 0
        if run["launches"]["radix_partition"] != want_part:
            raise AssertionError(f"run ({name}): {run['launches']['radix_partition']} "
                                 f"partition launches, not {want_part}")
        if run["over_model"]:
            raise AssertionError(f"run ({name}): table steps above the auto model's bytes a "
                                 f"row for their W: {run['over_model'][:4]}")
        run["peak_share_of_card"] = run["peak_device_bytes"] / mem
    # a planted site under no candidate must be one the reference explains: each of its
    # child k-mers seen fewer than twice in the child or seen in a parent (a parent's read
    # carrying the de novo base by a sequencing error hides the site at tau_parent = 0)
    missed = {int(p): dnm_evidence(sdir, data["child_hap"], int(p))
              for p in snvs_missed(data["candidates"], data["child_hap"], data["dnms"])}
    for p, ev in missed.items():
        if any(c >= 2 and m == 0 and d == 0
               for c, m, d in zip(ev["child"], ev["mom"], ev["dad"])):
            raise AssertionError(f"planted de novo SNV at {p} under no candidate, though a "
                                 f"k-mer over it is child-only: {ev}")
    for name in os.listdir(sdir):  # the reference's bucket files
        if re.fullmatch(r"(mom|dad|child)\.b\d+\.(keys|counts)\.npy", name):
            os.remove(os.path.join(sdir, name))
    emit({"phase": "scale", "spec": dataclasses.asdict(spec), "reads_per_sample": spec.reads,
          "card_bytes": mem, "data_s": t1 - t0, "data_seconds": data["seconds"],
          "background": None if early is None else {
              "workers": early.workers, "data_ended_after_s": early.ended_s.get("data")},
          "reference": data["ref"], "candidates": len(data["candidates"]),
          "planted_dnms": spec.dnms, "dnms_recovered": spec.dnms - len(missed),
          "dnms_hidden": missed,
          "batches": batches, "runs": runs})
    return {"dir": sdir, "data": data, "report": want,
            "runs": {name: {"launches": r["launches"]} for name, r in runs.items()}}


# ---------------------------------------------------------------------------------------
# phase 13: BASELINE config 4 at a real size, the k sweep over phase 12's trio
# ---------------------------------------------------------------------------------------

#: share of the host's available memory the references' shared k-mer buffers may take (the
#: rest is the workers' own arrays: a k > 32 bucket task holds ~2 GB)
SWEEP_SHM_SHARE = 0.6
#: the background pool of phases 12 and 13's references, at nice 19: one worker a core
EARLY_WORKERS = os.cpu_count()


def host_memory():
    """The host's MemTotal and MemAvailable (bytes), from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return {key: int(info[name].split()[0]) * 1024
            for key, name in (("total", "MemTotal"), ("available", "MemAvailable"))}


def sweep_references(spec, sdir, ks, workers=None, nice=0, on_pool=None, pool=None,
                     slots=None):
    """Phase 13's numpy reference at each k of ``ks`` over phase 12's reads (its haplotypes
    in ``sdir``): ``scale_counts`` without BAMs, one k at a time. Given ``slots``
    (``scale_slots``) the k's share them; else each k takes at most as many samples' shared
    buffers as fit ``SWEEP_SHM_SHARE`` of the host's available memory, and fails before it
    starts if not even one does. ``workers``, ``nice``, ``on_pool`` and ``pool`` go to
    ``scale_counts``. → {k: {"ref", "candidates", "live", "host", "seconds",
    "steps_s"}}."""
    refs = {}
    for k in ks:
        host = host_memory()
        if slots is None:
            size = values_bytes(spec, k)
            live = min(3, int(SWEEP_SHM_SHARE * host["available"]) // size)
            print(f"phase 13 reference k={k}: host RAM {host['total'] / 1e9:.1f} GB, "
                  f"{host['available'] / 1e9:.1f} GB available; {size / 1e9:.1f} GB of "
                  f"k-mer values a sample, {live} at a time", file=sys.stderr, flush=True)
            if live < 1:
                raise AssertionError(
                    f"the k={k} reference needs {size / 1e9:.1f} GB of shared memory a "
                    f"sample, more than {SWEEP_SHM_SHARE:.0%} of the host's "
                    f"{host['available'] / 1e9:.1f} GB available: refusing to run into swap")
        else:
            live = len(slots)
        kdir = os.path.join(sdir, f"k{k}")
        os.makedirs(kdir)
        t0 = time.perf_counter()
        out = scale_counts(spec, sdir, kdir, k, workers=workers, live=live, nice=nice,
                           on_pool=on_pool, pool=pool, slots=slots)
        shutil.rmtree(kdir)
        refs[k] = {"ref": out["ref"], "candidates": out["candidates"], "live": live,
                   "host": host, "seconds": time.perf_counter() - t0,
                   "steps_s": out["seconds"]}
    return refs


class ScaleJobs:
    """Phase 12's trio (its BAMs and its numpy reference at k = 31, ``scale_trio``) and then
    phase 13's references (``sweep_references`` at each other k of ``SWEEP_KS``), made from
    the script's start in a background thread, beside phases 1-11, on one spawn pool of
    ``EARLY_WORKERS`` workers at nice 19 and one set of shared k-mer buffers
    (``scale_slots``, paged in once for all four ks). Phases 1-11 leave most of the host's
    cores idle; they run somewhat slower beside the pool. The haplotypes are written first,
    into ``work/scale``. ``data()`` waits for phase 12's trio and returns it, ``refs()``
    for phase 13's references (each raises the job's error); ``close()`` stops the pool,
    joins the thread and frees the buffers."""

    def __init__(self, spec, work):
        self.sdir = os.path.join(work, "scale")
        os.makedirs(self.sdir)
        self.haplotypes = scale_haplotypes(spec, self.sdir)
        self.workers = EARLY_WORKERS
        self.t0 = time.perf_counter()
        self.ended_s = {}
        self.waited_s = {}
        self._pool, self._closed = None, False
        self._futures = {"data": concurrent.futures.Future(),
                         "refs": concurrent.futures.Future()}
        self._thread = threading.Thread(target=self._run, args=(spec,), daemon=True)
        self._thread.start()

    def _run(self, spec):
        try:
            with concurrent.futures.ProcessPoolExecutor(
                    self.workers, mp_context=multiprocessing.get_context("spawn"),
                    initializer=os.nice, initargs=(19,)) as pool, \
                    scale_slots(spec, SWEEP_KS) as slots:
                self._pool = pool
                if self._closed:
                    raise concurrent.futures.CancelledError()
                self._done("data", scale_trio(spec, self.sdir, haplotypes=self.haplotypes,
                                              pool=pool, slots=slots))
                self._done("refs", sweep_references(spec, self.sdir,
                                                    [k for k in SWEEP_KS if k != K],
                                                    pool=pool, slots=slots))
        except BaseException as e:  # noqa: BLE001  (handed to the phase that waits)
            for f in self._futures.values():
                if not f.done():
                    f.set_exception(e)

    def _done(self, name, result):
        self.ended_s[name] = time.perf_counter() - self.t0
        self._futures[name].set_result(result)

    def _wait(self, name):
        t0 = time.perf_counter()
        try:
            return self._futures[name].result()
        finally:
            self.waited_s[name] = time.perf_counter() - t0

    def data(self):
        return self._wait("data")

    def refs(self):
        return self._wait("refs")

    def close(self):
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        self._thread.join()


def phase_sweep_scale(work, spec, scale, early=None):
    """Phase 13: BASELINE config 4 at a real size. The numpy reference at k = 15, 21 and 41
    over phase 12's reads (k = 31 is phase 12's), then `sweep --ks 15,21,31,41` through
    the CLI on the card at table capacity 2^28 with --accum-batches auto on phase 12's
    BAMs, traced like phase 12's run (a). Each k's report must equal the reference's
    candidates at that k and k = 31's phase 12 run (a)'s, each k's tables_n the reference's
    unique counts, the extraction must launch once a batch a k, no table step may hold
    more device bytes a row than the auto model counts for its W, and the peak may not
    pass the modelled peak. The references are ``early``'s where given (``ScaleJobs``:
    computed in the background from the script's start), else computed here. The phase's line is printed before a failed check
    raises."""
    from denovo_kmer_tpu_torch import cli
    from denovo_kmer_tpu_torch.config import words_per_kmer

    sdir, data = scale["dir"], scale["data"]
    ks = list(SWEEP_KS)
    t0 = time.perf_counter()
    refs = (early.refs() if early is not None
            else sweep_references(spec, sdir, [k for k in ks if k != K]))
    refs[K] = {"ref": data["ref"], "candidates": data["candidates"], "live": None,
               "host": None,
               "seconds": data["seconds"]["chunks"] + data["seconds"]["buckets"]}
    t1 = time.perf_counter()
    paths = data["paths"]
    batch_reads, max_len = 16384, 160
    seeds = sorted(ks, key=lambda k: (words_per_kmer(k), k))

    def lanes(batches):
        return ({batches * batch_reads * (max_len - k + 1): k for k in ks}, seeds)

    pattern = os.path.join(sdir, "sweep.k{k}.tsv")
    argv = ["sweep", "--mom", paths["mom"], "--dad", paths["dad"], "--child", paths["child"],
            *SCALE_FLAGS, "--ks", ",".join(map(str, ks)), "--table-capacity",
            str(SCALE_CAPACITY), "-o", pattern]
    run = scale_cli(argv, os.path.join(sdir, "sweep_trace.json"), lanes)
    batches = 3 * -(-spec.reads // batch_reads)
    mem = torch.cuda.get_device_properties(0).total_memory
    model = cli.window_peak(run["auto_batches"], SCALE_CAPACITY, ks, max_len, batch_reads)
    with open(os.path.join(sdir, "a.tsv")) as f:
        report_a = f.read()
    per_k, failed = {}, []
    for k in ks:
        with open(pattern.format(k=k)) as f:
            report = f.read()
        ref_n = {name: r["n"] for name, r in refs[k]["ref"].items()}
        per_k[k] = {"candidates": report.count("\n") - 1, "uniques": run["tables_n"].get(k),
                    "reference_uniques": ref_n,
                    "reference_windows": {name: r["windows"]
                                          for name, r in refs[k]["ref"].items()},
                    "reference_s": refs[k]["seconds"], "reference_live": refs[k]["live"],
                    "reference_steps_s": refs[k].get("steps_s"),
                    "host_memory": refs[k]["host"]}
        if report != report_text(refs[k]["candidates"], k):
            failed.append(f"sweep k={k}: the report ({per_k[k]['candidates']} rows) differs "
                          f"from the numpy reference's {len(refs[k]['candidates'])} "
                          "candidates")
        if k == K and report != report_a:
            failed.append("sweep k=31: the report differs from phase 12 run (a)'s")
        if run["tables_n"].get(k) != ref_n:
            failed.append(f"sweep k={k}: tables_n {run['tables_n'].get(k)} != {ref_n}")
    if run["launches"]["extract_kmers"] != len(ks) * batches:
        failed.append(f"sweep: {run['launches']} launches for {batches} batches x {len(ks)} "
                      "ks")
    if run["launches"]["radix_partition"] != 0:
        failed.append(f"sweep: {run['launches']['radix_partition']} partition launches")
    if run["over_model"]:
        failed.append(f"sweep: table steps above the auto model's bytes a row for their "
                      f"step and W: {run['over_model'][:4]}")
    if run["peak_device_bytes"] > model:
        failed.append(f"sweep: peak {run['peak_device_bytes'] / 1e9:.2f} GB above the "
                      f"modelled {model / 1e9:.2f} GB")
    dev = run["device"] or {}
    emit({"phase": "sweep_scale", "power": power_line(), "ks": ks,
          "flags": argv[7:], "card_bytes": mem, "references_s": t1 - t0,
          "background": None if early is None else {
              "workers": early.workers, "ended_after_s": early.ended_s,
              "waited_s": early.waited_s},
          "per_k": per_k, "auto": run["accum_line"], "auto_batches": run["auto_batches"],
          "modelled_peak_bytes": model, "peak_device_bytes": run["peak_device_bytes"],
          "peak_share_of_card": run["peak_device_bytes"] / mem,
          "wall_s": run["wall_s"], "feed_wait_s": run["feed_wait_s"],
          "busy_s": dev.get("busy_s"), "idle_share": dev.get("idle_share"),
          "extract_launches": run["launches"]["extract_kmers"],
          "extract_kernel_s": dev.get("extract_kernel_s"), "failed": failed, "run": run})
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": run["launches"]}


def device_time(prof, trace_path, wall_s):
    """Device activity of a profiled run, from its Chrome trace: busy seconds (the union of
    every kernel, copy and memset interval), summed seconds by kind and for the costliest
    kernels, and the idle share of ``wall_s``. None where the trace holds no device event
    (a profiler that cannot trace the card): the smoke's checks do not depend on it."""
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, kernels, extract_events = [], {}, 0
    kinds = {"extract_kernel": 0.0, "partition_kernel": 0.0, "other_kernels": 0.0,
             "copies": 0.0}
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        spans.append((ts, ts + dur))
        name = e.get("name", "")
        if cat != "kernel":
            kinds["copies"] += dur
        elif "extract_kmers_kernel" in name:
            kinds["extract_kernel"] += dur
            extract_events += 1
        elif "radix_partition" in name:
            kinds["partition_kernel"] += dur
        else:
            kinds["other_kernels"] += dur
        if cat == "kernel":
            kernels[name[:100]] = kernels.get(name[:100], 0.0) + dur
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"events": len(spans), "extract_kernel_events": extract_events,
            "busy_s": busy, "idle_share": 1.0 - busy / wall_s,
            **{f"{kind}_s": s for kind, s in kinds.items()},
            "top_kernels_s": dict(top)}


def phase_feeder():
    """Build the port's native library (the C++ BAM feeder and the CRAM codecs; g++, zlib)
    on this host: phases 4 and 8 require it."""
    from denovo_kmer_tpu_torch.io import native

    t0 = time.perf_counter()
    ok = native.native_available()
    out = {"phase": "feeder", "native": ok, "build_error": native.native_build_error(),
           "seconds": time.perf_counter() - t0,
           "threads": os.environ.get("DENOVO_KMER_INGEST_THREADS", "4 (default)")}
    emit(out)
    if not ok:
        raise AssertionError(f"the C++ BAM feeder did not build: {out['build_error']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs a CUDA card",
              file=sys.stderr)
        return 1
    from denovo_kmer_tpu_torch.utils.cuda_build import load_all

    t_start = time.perf_counter()
    emit({"phase": "start", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "power": power_line(),
          "max_sm_clock_mhz": max_sm_clock_mhz(),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "int_ops_per_s": int_ops_per_s()})

    t0 = time.perf_counter()
    load_all(KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": KERNELS})
    phase_feeder()

    rng = np.random.default_rng(args.seed)
    cases, worst, shard_case = phase_kernels(rng)
    part_cases = phase_partition()
    sort_case = phase_block_sort()
    merge_case = phase_table_merge()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    early = None
    try:
        # phase 12's trio and phase 13's references are made from here, beside phases
        # 1-11, on the cores they leave
        early = ScaleJobs(ScaleSpec(seed=args.seed), work)
        small = phase_parity(work)
        phase_parity_buckets(work)
        phase_parity_slice(work, small)
        phase_parity_inputs(work, small)
        sharded_small = phase_parity_sharded(work, small)
        main_run = phase_main(rng, work)
        multipass = phase_multipass(work, main_run["paths"], main_run["report"],
                                    main_run["batches"])
        ckpt = phase_checkpoints(rng, work, main_run)
        buckets = phase_buckets(rng, work, main_run)
        with no_plain_extraction():
            sweep = phase_sweep(main_run)
            cohort = phase_cohort(rng, work, main_run)
            evidence = phase_evidence_sites(work, main_run)
            inputs = phase_inputs(work, main_run, evidence)
            sharded = phase_sharded(main_run)
            multihost = phase_multihost(work, main_run)
            phase_table_tools(work, main_run)
            library = phase_library(main_run)
            scale = phase_scale(work, ScaleSpec(seed=args.seed), early)
            sweep_scale = phase_sweep_scale(work, ScaleSpec(seed=args.seed), scale, early)
    finally:
        if early is not None:
            early.close()
        shutil.rmtree(work, ignore_errors=True)

    main_case = next(c for c in cases if c["k"] == K and c["canonical"] and c["max_read_len"]
                     == 160 and c["feed"] == "lengths" and "n_passes" not in c)
    vw_case = next(c for c in cases if c["k"] == K and c["canonical"] and c["max_read_len"]
                   == 160 and c["feed"] == "vwords" and "n_passes" not in c)
    spill_case = part_cases[0]
    launches = multipass["spill_store"]["launches"]
    by_path = {"run_trio_sharded_2x4": sharded["launches"],
               **{f"multihost_{name}_rank0": case["rank0"]["launches"]
                  for name, case in multihost["cases"].items()},
               **{f"small_{name}": r["launches"] for name, r in sharded_small.items()},
               "cli_mesh_1x1": sharded["cli_mesh_1x1"]["launches"],
               "run_trio": main_run["launches"],
               **{name: r["launches"] for name, r in multipass.items()},
               **{name: r["launches"] for name, r in buckets.items()},
               "run_trio_npz": ckpt["run_trio_npz"]["launches"],
               "count_mom": ckpt["count_mom"]["launches"],
               "sweep": sweep["launches"], "cohort": cohort["launches"],
               **evidence["launches"], **inputs,
               **{f"library_{name}": v for name, v in library["launches"].items()},
               "scale_run_trio": scale["runs"]["a"]["launches"],
               f"scale_spill_{SCALE_PASSES}": scale["runs"]["b"]["launches"],
               "scale_sweep": sweep_scale["launches"]}
    standalone = library["extract_fast"][0]  # k=31, canonical
    emit({"kernels": [{
        "name": "extract_kmers", "route": "cuda",
        "source": "denovo_kmer_tpu_torch/csrc/extract_kmers.cu",
        "replaces": "denovo_kmer_tpu/ops/extract_pallas.py:42",
        "launches": sweep_scale["launches"]["extract_kmers"],
        "max_abs_err": worst, "max_abs_diff": worst,
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "store_floor_ms": main_case["store_floor_ms"],
        "ms_vwords_feed": vw_case["ms"], "plain_ms_vwords_feed": vw_case["plain_ms"],
        "bound_ms_vwords_feed": vw_case["bound_ms"],
        "ms_by_bucket_width": {c["max_read_len"]: c["ms"] for c in cases
                               if c["k"] == K and c["canonical"] and c["feed"] == "lengths"
                               and "n_passes" not in c},
        "launches_by_path": {name: v["extract_kmers"] for name, v in by_path.items()},
        "sharded_launch": {key: shard_case[key] for key in
                           ("B", "ms", "plain_ms", "bound_ms", "bound_by", "store_floor_ms")},
        "standalone_launch": {key: standalone[key] for key in
                              ("B", "k", "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "invalid_keys_differing")},
        "shape": "B=16384 max_read_len=160 k=31 canonical; launches: phase 13's sweep at "
                 "k = 15, 21, 31, 41 over the chr20-length 30x trio, one a batch a k; "
                 "standalone_launch: "
                 "ops/extract_fast.extract_canonical_kmers_fast on one child batch, the "
                 "whole call (allocation, launch, int64 widening) against the plain version"},
        {
        "name": "radix_partition", "route": "cuda",
        "source": "denovo_kmer_tpu_torch/csrc/radix_partition.cu",
        "replaces": "denovo_kmer_tpu/ops/partition_pallas.py:125",
        "launches": launches["radix_partition"],
        "max_abs_err": max(c["max_abs_err"] for c in part_cases),
        "ms": spill_case["ms"], "plain_ms": spill_case["plain_ms"],
        "bound_ms": spill_case["bound_ms"], "bound_by": spill_case["bound_by"],
        "library_ms": spill_case["library_ms"],
        "partition_window_ms": spill_case["partition_window_ms"],
        "by_shape": {c["shape"]: {key: c[key] for key in ("ms", "bound_ms")}
                     for c in part_cases},
        "launches_by_path": {name: v["radix_partition"] for name, v in by_path.items()},
        "shape": f"N={spill_case['N']} C=2 n_buckets=5 block_lanes=32768 (spill window)"}, {
        "name": "block_sort", "route": "cuda",
        "source": "denovo_kmer_tpu_torch/csrc/block_sort.cu",
        "replaces": "benchmarks/micro_pallas_sort.py:73",
        "launches": launches["block_sort"],
        "max_abs_err": max(sort_case["max_abs_err"], sort_case["edge_max_abs_err"]),
        "ms": sort_case["ms"], "plain_ms": sort_case["plain_ms"],
        "bound_ms": sort_case["bound_ms"], "bound_by": sort_case["bound_by"],
        "library_ms": sort_case["library_ms"], "copy_floor_ms": sort_case["copy_floor_ms"],
        "resources": sort_case["resources"],
        "launches_by_path": {name: v["block_sort"] for name, v in by_path.items()},
        "shape": "keys, pays (2^22, 128) u32, 2048-row blocks (a probe: no path calls it)"}, {
        "name": "table_merge", "route": "cuda",
        "source": "denovo_kmer_tpu_torch/csrc/table_merge.cu",
        "replaces": None,
        "launches": sweep_scale["launches"]["table_merge"],
        "max_abs_err": merge_case["max_abs_err"],
        "ms": merge_case["ms"], "plain_ms": merge_case["plain_ms"],
        "bound_ms": merge_case["bound_ms"], "bound_by": merge_case["bound_by"],
        "library_ms": merge_case["library_ms"],
        "launches_by_path": {name: v["table_merge"] for name, v in by_path.items()},
        "shape": "a flush of the call cell: W = 2, a 2^28-row table holding 120M keys and "
                 "80M window keys, 40M shared; library: torch.sort of the 200M keys"}],
        "unported": []})
    emit({"phase": "end", "seconds": time.perf_counter() - t_start})
    print(power_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
