#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (denovo_kmer_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with an NVIDIA card (sm_90a, nvcc under
/usr/local/cuda or $CUDA_HOME) and g++ with zlib. It exits non-zero, printing no result,
without a card or without the package beside it. Phases, each printed as one JSON line:

1. build    — compile every CUDA kernel from denovo_kmer_tpu_torch/csrc, one nvcc a source,
              all started together; then the C++ BAM feeder (g++, zlib), which must build.
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
              and resident CTAs an SM at every height from 2,048 up. Operations bounds
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
              group_sites: identical reports, superset rows and file bytes.
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
              Then a mixed-length trio (phase 4's reads trimmed to 60-151 bp): run_trio, and
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

BAMs store reverse-strand reads in reference orientation at the position of their first
stored base, as an aligner does; canonical counting does not see the strand. Each path of
phases 4 to 7 runs with every kernel's launch count set to 0 just before it and read just
after; the counts come from those runs alone (the block sort is a probe that no path
launches). Then a ``kernels`` line (one entry per kernel), the card's name and
power limit as nvidia-smi gives them, and last ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ["extract_kmers", "radix_partition", "block_sort"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# 32-bit integer add, compare and min/max results a clock an SM at compute capability 9.0
# (CUDA C++ Programming Guide, throughput of native arithmetic instructions)
INT_RESULTS_PER_CLOCK_SM = 64


def emit(obj) -> None:
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
    return cases, worst


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


def sample_reads(rng, genome, n_rate, n=N_READS):
    """n reads of READ_LEN from random positions, half reverse-complemented; codes with 4 = N."""
    pos = rng.integers(0, len(genome) - READ_LEN + 1, size=n)
    codes = genome[pos[:, None] + np.arange(READ_LEN)[None, :]]
    rev = rng.random(n) < 0.5
    codes[rev] = 3 - codes[rev, ::-1]
    if n_rate:
        codes[rng.random(codes.shape) < n_rate] = 4
    return pos, rev, codes


def write_bam(path, name, codes, pos, rev, genome_len, lens=None):
    """One BAM record a row of ``codes`` (reads as sequenced); ``lens`` trims row i to its
    first lens[i] bases. A reverse-strand read is stored as an aligner stores it: in
    reference orientation (the trimmed read reverse-complemented), at the reference position
    of its first stored base."""
    from denovo_kmer_tpu_torch.io.bam import BamRecord, BamWriter

    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    text = alphabet[codes].tobytes().decode()
    # row i reverse-complemented: its trimmed read's reverse complement is the row's last n
    text_rc = alphabet[np.where(codes < 4, 3 - codes, 4)[:, ::-1]].tobytes().decode()
    L = codes.shape[1]
    with open(path, "wb") as f, BamWriter(f, references=[("chrS", genome_len)],
                                          level=1) as w:
        for i in range(codes.shape[0]):
            n = L if lens is None else int(lens[i])
            if rev[i]:
                seq, start = text_rc[i * L + L - n:(i + 1) * L], int(pos[i]) + L - n
            else:
                seq, start = text[i * L:i * L + n], int(pos[i])
            w.write(BamRecord(name=f"{name}_r{i}", flag=0x10 if rev[i] else 0, refid=0,
                              pos=start, mapq=60, cigar=((n, 0),), seq=seq))


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
    bits of k, so the cost grows with log k."""
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
    hi, lo, valid = window_words(codes, k)
    if hi is None:
        keys, counts = np.unique(lo[valid], return_counts=True)
        return keys, counts, int(valid.sum())
    rows = np.stack([hi[valid], lo[valid]], axis=1)
    del hi, lo
    rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    start = np.ones(rows.shape[0], bool)
    start[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    at = np.nonzero(start)[0]
    return rows[at], np.diff(np.append(at, rows.shape[0])), int(valid.sum())


def _rows_in(a, b):
    """Which rows of ``a`` are rows of ``b`` (each (m, 2), rows unique within each)."""
    both = np.concatenate([a, b])
    order = np.lexsort((both[:, 1], both[:, 0]))
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
    ref = {name: reference_counts(codes) for name, (_, _, codes) in samples.items()}
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
          "python_feeder": {**stages(m_py, t8 - t7), "launches": launches_py,
                            "native_feeder_batches": native_batches_py}})
    return dict(paths=paths, report=res.report, batches=batches, samples=samples, ref=ref,
                launches=launches, wall_s=t4 - t3, genome=genome, child_genome=child_genome,
                snvs=snvs, candidates=res.candidates)


def _counters():
    from denovo_kmer_tpu_torch.ops.block_sort import block_sort
    from denovo_kmer_tpu_torch.ops.extract import extract_append
    from denovo_kmer_tpu_torch.ops.partition import partition_kernel

    return {"extract_kmers": extract_append, "radix_partition": partition_kernel,
            "block_sort": block_sort}


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
    """A mixed-length trio from phase 4's reads (each trimmed to 60-151 bp): run_trio,
    the device-store spill and the 2-pass re-decode with read_len_buckets BUCKETS each equal
    the unbucketed run_trio on the same BAMs."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.pipeline import run_trio, run_trio_multipass, run_trio_spill
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    t0 = time.perf_counter()
    paths, bases = write_mixed_trio(rng, os.path.join(work, "mixed"), samples=main["samples"])
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
    emit({"phase": "buckets", "buckets": list(BUCKETS), "bases": bases, "bam_write_s": bam_s,
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
    for k in SWEEP_KS:
        ref = main["ref"] if k == K else {
            name: reference_counts(codes, k) for name, (_, _, codes) in main["samples"].items()}
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
    ref_b = {name: reference_counts(codes) for name, (_, _, codes) in samples_b.items()}
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
    return out


def device_time(prof, trace_path, wall_s):
    """Device activity of a profiled run, from its Chrome trace: busy seconds (the union of
    every kernel, copy and memset interval), summed seconds by kind and for the costliest
    kernels, and the idle share of ``wall_s``. None where the trace holds no device event
    (a profiler that cannot trace the card): the smoke's checks do not depend on it."""
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, kernels = [], {}
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
    return {"events": len(spans), "busy_s": busy, "idle_share": 1.0 - busy / wall_s,
            **{f"{kind}_s": s for kind, s in kinds.items()},
            "top_kernels_s": dict(top)}


def phase_feeder():
    """Build the C++ BAM feeder (g++, zlib) on this host: phase 4 requires it."""
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
    cases, worst = phase_kernels(rng)
    part_cases = phase_partition()
    sort_case = phase_block_sort()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    try:
        small = phase_parity(work)
        phase_parity_buckets(work)
        phase_parity_slice(work, small)
        main_run = phase_main(rng, work)
        multipass = phase_multipass(work, main_run["paths"], main_run["report"],
                                    main_run["batches"])
        ckpt = phase_checkpoints(rng, work, main_run)
        buckets = phase_buckets(rng, work, main_run)
        with no_plain_extraction():
            sweep = phase_sweep(main_run)
            cohort = phase_cohort(rng, work, main_run)
            evidence = phase_evidence_sites(work, main_run)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_case = next(c for c in cases if c["k"] == K and c["canonical"] and c["max_read_len"]
                     == 160 and c["feed"] == "lengths" and "n_passes" not in c)
    vw_case = next(c for c in cases if c["k"] == K and c["canonical"] and c["max_read_len"]
                   == 160 and c["feed"] == "vwords" and "n_passes" not in c)
    spill_case = part_cases[0]
    launches = multipass["spill_store"]["launches"]
    by_path = {"run_trio": main_run["launches"],
               **{name: r["launches"] for name, r in multipass.items()},
               **{name: r["launches"] for name, r in buckets.items()},
               "run_trio_npz": ckpt["run_trio_npz"]["launches"],
               "count_mom": ckpt["count_mom"]["launches"],
               "sweep": sweep["launches"], "cohort": cohort["launches"],
               **evidence["launches"]}
    emit({"kernels": [{
        "name": "extract_kmers", "route": "cuda",
        "source": "denovo_kmer_tpu_torch/csrc/extract_kmers.cu",
        "replaces": "denovo_kmer_tpu/ops/extract_pallas.py:42",
        "launches": launches["extract_kmers"],
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
        "shape": "B=16384 max_read_len=160 k=31 canonical"}, {
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
        "shape": "keys, pays (2^22, 128) u32, 2048-row blocks (a probe: no path calls it)"}],
        "unported": []})
    emit({"phase": "end", "seconds": time.perf_counter() - t_start})
    print(power_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
