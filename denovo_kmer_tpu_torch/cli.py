"""Command-line interface of the PyTorch/CUDA port. Usage:

    python -m denovo_kmer_tpu_torch call --mom mom.bam --dad dad.bam --child child.bam \
        -k 31 -o candidates.tsv [--device cuda|cpu] [--passes N [--spill DIR | --spill-rows N]]

Subcommands (the same flags and output as ``python -m denovo_kmer_tpu``):
    call        full trio workflow (index parents, score child, report). ``--passes N``
                splits the key space into N hash passes: alone it re-decodes the reads
                every pass; with ``--spill DIR`` (host files, resumable) or ``--spill-rows
                N`` (a device store of N rows a pass) it decodes once and spills. A parent
                given as a ``count`` checkpoint (``.npz``) is loaded, not built.
                ``--evidence-out`` / ``--sites-out`` also run ``evidence`` / ``sites`` on
                the candidates
    sweep       multi-k sweep over one trio (``--ks 15,21,31,41``): one decode a sample
    cohort      N trios (a manifest, or ``--ped``) through one engine, with the parental
                superset table
    evidence    the child reads holding any candidate k-mer, to BAM, SAM or FASTQ
    sites       group a candidate TSV into loci using the child reads' evidence
    count       build one sample's table and save it as an ``.npz`` checkpoint
                (``--resume``: mid-pass resume from ``<output>.resume.npz``)
    probe       query k-mer counts in a ``count`` checkpoint (``--kmers`` or stdin)
    merge       merge ``count`` checkpoints with count addition (on ``--device``)
    stats, histo, dump
                summary, multiplicity spectrum and k-mer dump of a ``count`` checkpoint
    view        convert/filter reads: SAM/BAM/FASTQ/FASTA/CRAM 3.0 and 3.1 out, ``-s``,
                ``-c``, ``-F``, regions
    flagstat, idxstats, depth, bedcov
                flag categories, per-reference counts, per-base and per-BED coverage
    index       BAI/CSI for a sorted BAM, CRAI for a CRAM, FAI for a FASTA, TBI for a
                bgzipped VCF
    sort, faidx, bgzip
                coordinate-sort a BAM, fetch FASTA regions, BGZF (de)compression and .gzi
    doctor      environment self-check (torch and its cards, ``--mesh``, the native shim,
                nvcc); ``--probe-feed READS`` measures feeder supply against the card's
                demand
    synth-trio  generate a deterministic synthetic trio (test/bench fixture)

Reads come from BAM, CRAM (3.0/3.1; ``--reference`` for reference-based CRAM), SAM (plain or
gzip), FASTQ or FASTA, as local paths or ``http(s)://``, ``s3://`` and ``gs://`` URLs.
``--region chr20:1-2,000`` (BAM through its .bai/.csi, CRAM through its .crai, a full-scan
filter without an index) or ``--regions-bed`` (BAM) restricts the reads.
``--read-len-buckets 64,112,160`` packs and extracts each read at the smallest width that
holds it; ``--ingest-threads N`` sets the C++ BAM feeder's decode threads; ``call
--profile-dir DIR`` writes a ``torch.profiler`` Chrome trace. ``--mesh RxT`` runs ``call`` (plain,
``--passes N``, ``--passes N --spill-rows N``), ``sweep`` and ``cohort`` on the sharded engine
over an R x T mesh: R·T cards, or with ``--device cpu`` R·T copies of the CPU; ``doctor
--mesh RxT`` reports the mesh it would build; the other subcommands accept the flag and
ignore it, as the JAX CLI does. Multi-process runs are a library entry point
(``parallel/multihost.run_trio_multihost``), as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from denovo_kmer_tpu_torch.config import DEFAULT_FILTER_MASK, EngineConfig

def _int_maybe_hex(s: str) -> int:
    return int(s, 0)


def _mesh_shape(s: str):
    parts = s.lower().split("x")
    try:
        if len(parts) != 2:
            raise ValueError
        r, t = int(parts[0]), int(parts[1])
        if r < 1 or t < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"mesh must be READSxTABLE with positive ints (e.g. 4x2), got {s!r}"
        ) from None
    return (r, t)


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("semantics (SPEC_SEMANTICS.md)")
    g.add_argument("-k", "--kmer-size", type=int, default=31)
    g.add_argument("--no-canonical", action="store_true",
                   help="count forward-strand k-mers only")
    g.add_argument("--filter-flag-mask", type=_int_maybe_hex, default=DEFAULT_FILTER_MASK,
                   help="skip records with (flag & mask) != 0 (default 0x%(default)x)")
    g.add_argument("--min-base-quality", type=int, default=0)
    g.add_argument("--tau-parent", type=int, default=0,
                   help="max parental count for a candidate")
    g.add_argument("--min-child-count", type=int, default=2)
    e = p.add_argument_group("engine sizing")
    e.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engine runs (default: the CUDA card; fails without one)")
    e.add_argument("--batch-reads", type=int, default=4096)
    e.add_argument("--max-read-len", type=int, default=160)
    e.add_argument("--table-capacity", type=int, default=1 << 20)
    e.add_argument("--mesh", type=_mesh_shape, default=(1, 1),
                   help="mesh shape READSxTABLE, e.g. 4x2 (multi-device: R*T cards, or "
                        "R*T copies of the CPU with --device cpu)")
    e.add_argument("--read-len-buckets", default=None,
                   help="comma list of ascending padded read widths (last = "
                        "--max-read-len), e.g. 64,112,160: mixed-length inputs skip "
                        "padding waste (bit-identical results)")
    e.add_argument("--accum-batches", default="32",
                   help="batches staged per accumulation window before a flush. Integer, "
                        "or 'auto' to size from the device's memory (CLI default 32; the "
                        "library EngineConfig default is a conservative 8)")
    e.add_argument("--region", default=None,
                   help="restrict BAM/CRAM inputs to a genomic region (chr20 or "
                        "chr20:1,000-2,000; uses a .bai/.csi/.crai next to the file when "
                        "present, full-scan filter otherwise)")
    e.add_argument("--regions-bed", default=None,
                   help="restrict BAM inputs to the intervals of a BED3+ file "
                        "(merged per contig, each overlapping read counted once "
                        "- samtools view -M -L semantics)")
    e.add_argument("--passes", type=int, default=1,
                   help="hash-pass partitioned multi-pass build: each pass's table holds "
                        "~1/N of the uniques (re-decodes the reads every pass unless "
                        "--spill/--spill-rows is given)")
    e.add_argument("--spill", default=None, metavar="DIR",
                   help="with --passes: decode once and spill per-pass k-mer rows to host "
                        "files in DIR (resumable: a finished sample is never re-decoded)")
    e.add_argument("--spill-rows", type=int, default=None, metavar="N",
                   help="with --passes: decode once and spill per-pass k-mer rows to a "
                        "device store of N rows a pass")
    e.add_argument("--reference", default=None,
                   help="reference FASTA (for reference-based CRAM inputs)")
    e.add_argument("--extractor", choices=("fast", "fast_t", "pallas"), default="fast",
                   help="extraction layout of the JAX package; every value runs the same "
                        "CUDA kernel here")
    e.add_argument("--output-format", choices=("tsv", "fasta"), default="tsv",
                   help="candidate report format (tsv is the parity artifact)")
    e.add_argument("--ingest-threads", type=int, default=None,
                   help="decode worker threads of the C++ BAM feeder (BGZF inflate ring; "
                        "default 4; 0 = synchronous; also via DENOVO_KMER_INGEST_THREADS)")
    e.add_argument("--json-metrics", action="store_true")
    e.add_argument("--profile-dir", type=str, default=None,
                   help="`call`: write a torch.profiler Chrome trace (CPU and CUDA "
                        "activity) of the run into this directory; the other "
                        "subcommands accept the flag and ignore it")


def _resolve_region(args):
    """--region (single string) or --regions-bed (BED file -> region list);
    mutually exclusive. The list form flows through every pipeline's
    _record_stream (multi-region BAM iterator, samtools view -M -L)."""
    bed = getattr(args, "regions_bed", None)
    if bed:
        if args.region:
            raise SystemExit("--region and --regions-bed are mutually exclusive")
        from denovo_kmer_tpu_torch.io.bai import parse_bed

        return parse_bed(bed)
    return args.region


def _profiler(args):
    """``--profile-dir``: a ``torch.profiler`` context over the call (CPU activity, and CUDA
    on the card) that writes a Chrome trace (``*.pt.trace.json``) into the directory; a
    null context without the flag."""
    import contextlib

    if not args.profile_dir:
        return contextlib.nullcontext()
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if args.device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(args.profile_dir))


#: Device bytes a row that a table step holds beyond its input and output tables, by key words
#: W and step: "flush" (a parent's flush, a child's compacting flush, the spill's partition
#: and pass steps: rows of capacity + staging window), "seed" (the scoring table's seed:
#: rows of both parents' capacities) and "call" (the fused call: rows of capacity + window).
#: A flush sorts only its staged rows (the int64 sort key a row, two for W > 2, and
#: torch's sort scratch: ``ops/table._staged_groups``) and merges them into the table
#: (``ops/table._merge_sorted``); a seed merges the parents and sorts nothing. The fused call
#: sorts its whole table and window (``ops/table._sorted_groups`` in
#: ``ops/fused._call_parts``: the sort keys, torch.sort's sorted keys, permutation and radix
#: scratch, the weight columns and their scans). The values were fitted when a flush and a
#: seed sorted their table too, and are kept: they over-state both, and the call's bytes set
#: the plan's peak. chip_smoke.py phases 12 and 13 measure every step on the card at W = 1,
#: 2, 3 and fail if one takes more. The most measured on an H100 before the merge (flush /
#: seed / call): W = 1 45.9 / 45.1 / 51.5, W = 2 53.8 / 49.2 / 53.1, W = 3 63.3 / 61.1 /
#: 75.2. The W = 3 seed keeps 72: at 66 the sweep's plan (104 batches a window) ran out of
#: memory with 27 GiB of the caching allocator's blocks free but split.
STEP_BYTES_PER_ROW = {1: {"flush": 56, "seed": 56, "call": 56},
                      2: {"flush": 56, "seed": 56, "call": 56},
                      3: {"flush": 72, "seed": 72, "call": 80}}
STEP_BYTES_PER_ROW[4] = STEP_BYTES_PER_ROW[3]  # two sort keys, as at W = 3
#: a flush's bytes a row at W <= 2 (one sort key a row): k <= 32
FLUSH_BYTES_PER_ROW = STEP_BYTES_PER_ROW[2]["flush"]
#: share of the card's memory that ``--accum-batches auto`` plans for (the rest is the
#: caching allocator's slack)
AUTO_MEMORY_SHARE = 0.85
AUTO_MAX_BATCHES = 128


def _lanes(k) -> list:
    """The ks of a run (an int, or a sweep's ks) in the order the sweep seeds its lanes:
    narrowest first (``cohort.run_trio_multi_k``)."""
    from denovo_kmer_tpu_torch.config import words_per_kmer

    ks = [k] if isinstance(k, int) else list(dict.fromkeys(int(x) for x in k))
    return sorted(ks, key=lambda x: (words_per_kmer(x), x))


def _lane_rows(batches: int, k: int, max_read_len: int, batch_reads: int, mesh) -> int:
    """Staging rows of one lane's window (a mesh shard's share of it)."""
    return batches * -(-batch_reads * max(max_read_len - k + 1, 0)
                       // max(mesh[0] * mesh[1], 1))


def window_peak(batches: int, capacity: int, k, max_read_len: int, batch_reads: int,
                mesh=(1, 1), passes: int = 1, spill_rows=None) -> int:
    """The modelled device peak (bytes, per device) of a run whose staging windows hold
    ``batches`` batches; ``k`` is the run's k, or a sweep's list of ks (one lane a k, each
    with its own staging window and tables). A mesh splits the window over R·T shards and
    the table over T. A ``KmerTable`` row costs 4W+4 B and a ``ScoreTable`` row 4W+8 B
    (int32 words and counts, as in the JAX package), a staged row 4W+1 B, and a table step
    over N rows ``STEP_BYTES_PER_ROW[W][step]``·N beyond its tables. The peak is the largest
    of: a lane's flush in dad's build (mom's tables, dad's tables and staging windows
    resident: three tables for one k); each lane's seed over its two parents (at twice the
    capacity), narrowest lane first, beside the parental tables not yet seeded from and the
    lanes already seeded; a lane's flush or fused call in the child's stream (every scoring
    table and window resident; the parents are released once seeded). With the
    device-store spill (one k, ``passes`` > 1 and ``spill_rows``) the three samples' stores
    (``ops/spill.alloc_pass_rows`` rows a pass) stay beside the last spill's partition and
    the counting passes' tables."""
    from denovo_kmer_tpu_torch.config import words_per_kmer
    from denovo_kmer_tpu_torch.ops.spill import alloc_pass_rows, spill_capacity

    C = -(-capacity // max(mesh[1], 1))
    lanes = []  # (staging rows, KmerTable row, ScoreTable row, staged row, step bytes) a k
    for kk in _lanes(k):
        W = words_per_kmer(kk)
        lanes.append((_lane_rows(batches, kk, max_read_len, batch_reads, mesh), 4 * W + 4,
                      4 * W + 8, 4 * W + 1, STEP_BYTES_PER_ROW[W]))
    if passes > 1 and spill_rows is not None:
        if len(lanes) != 1:
            raise ValueError("the spill runs one k")
        (S, kt, st, row, F), = lanes
        W = (row - 1) // 4
        alloc = alloc_pass_rows(-(-spill_rows // S) * S, spill_capacity(S, passes, 1.4), S)
        stores = 3 * passes * alloc * 4 * W
        # the last sample's spill: its staging window and partition beside the stores; then
        # each pass folds store chunks of S rows: dad's with mom's table resident, the
        # seed (at capacity C) over both, a child flush once the parents are released
        flush = (C + S) * F["flush"]
        return stores + max(S * (row + F["flush"]), 3 * C * kt + flush,
                            2 * C * kt + 2 * C * F["seed"] + C * st, 2 * C * st + flush)
    staged = sum(S * row for S, _kt, _st, row, _F in lanes)
    parents = 2 * C * sum(kt for _S, kt, _st, _r, _F in lanes)
    peak = parents + staged + max((C + S) * F["flush"] + C * kt
                                  for S, kt, _st, _r, F in lanes)
    seeded = 0
    for S, kt, st, row, F in lanes:
        peak = max(peak, parents + seeded + 2 * C * (F["seed"] + st))
        parents -= 2 * C * kt
        seeded += C * st + S * row
    return max(peak, seeded + max(max((C + S) * F["flush"] + C * st, (C + S) * F["call"])
                                  for S, _kt, st, _r, F in lanes))


def auto_window_plan(mem: int, capacity: int, k, max_read_len: int, batch_reads: int,
                     mesh=(1, 1), passes: int = 1, spill_rows=None) -> dict:
    """``--accum-batches auto`` as a pure function of the card's memory (bytes) and the
    run's shapes (``k``: the run's k, or a sweep's ks): the most batches a staging window
    (at most ``AUTO_MAX_BATCHES``) whose ``window_peak`` fits ``AUTO_MEMORY_SHARE`` of
    ``mem``; at least 1. → {"batches", "window_rows" (summed over the lanes), "lane_rows"
    ({k: a lane's staging rows}), "peak", "budget"}."""
    budget = int(mem * AUTO_MEMORY_SHARE)
    shape = (capacity, k, max_read_len, batch_reads, mesh, passes, spill_rows)
    n = AUTO_MAX_BATCHES
    while n > 1 and window_peak(n, *shape) > budget:
        n -= 1
    lane_rows = {kk: _lane_rows(n, kk, max_read_len, batch_reads, mesh) for kk in _lanes(k)}
    return {"batches": n, "window_rows": sum(lane_rows.values()), "lane_rows": lane_rows,
            "peak": window_peak(n, *shape), "budget": budget}


def _accum_kwargs(args) -> dict:
    """--accum-batches: integer, or 'auto' = the largest staging window whose modelled
    device peak fits the card (``auto_window_plan``) at the run's table capacity, over the
    sweep's ks (``--ks``) for ``sweep``."""
    raw = args.accum_batches
    if str(raw) != "auto":
        return {"accum_batches": int(raw)}
    import torch

    from denovo_kmer_tpu_torch.config import words_per_kmer

    if args.device == "cuda" and torch.cuda.is_available():
        mem = torch.cuda.get_device_properties(0).total_memory
    else:
        mem = 4 << 30
    ks = ([int(x) for x in args.ks.split(",")] if getattr(args, "ks", None)
          else args.kmer_size)
    plan = auto_window_plan(mem, args.table_capacity, ks, args.max_read_len,
                            args.batch_reads, tuple(args.mesh), getattr(args, "passes", 1),
                            getattr(args, "spill_rows", None))
    lanes = plan["lane_rows"]

    def step_bytes(w):
        b = STEP_BYTES_PER_ROW[w]
        return "/".join(str(b[step]) for step in ("flush", "seed", "call"))

    if isinstance(ks, int):
        flush = f"{step_bytes(words_per_kmer(ks))} B a flush/seed/call row"
    else:  # the sweep: each lane's window, and the steps' bytes by key words
        flush = ("B a flush/seed/call row by key words " + ", ".join(
            f"W={w}: {step_bytes(w)}"
            for w in dict.fromkeys(words_per_kmer(x) for x in lanes))
            + "; ks " + ",".join(map(str, lanes)) + ", staging rows a lane "
            + ", ".join(f"k={x}: {r}" for x, r in lanes.items()))
    print(f"accum auto: {plan['batches']} batches/window ({plan['window_rows']} staging "
          f"rows; modelled peak {plan['peak'] / 1e9:.2f} GB of a {plan['budget'] / 1e9:.2f} GB "
          f"budget = {AUTO_MEMORY_SHARE:.0%} of {mem / 1e9:.0f} GB, table capacity "
          f"{args.table_capacity}, {flush})", file=sys.stderr)
    return {"accum_batches": plan["batches"]}


def _cfg_from_args(args) -> EngineConfig:
    if getattr(args, "ingest_threads", None) is not None:
        os.environ["DENOVO_KMER_INGEST_THREADS"] = str(args.ingest_threads)
    return EngineConfig(
        k=args.kmer_size,
        canonical=not args.no_canonical,
        filter_flag_mask=args.filter_flag_mask,
        min_base_quality=args.min_base_quality,
        tau_parent=args.tau_parent,
        min_child_count=args.min_child_count,
        batch_reads=args.batch_reads,
        max_read_len=args.max_read_len,
        table_capacity=args.table_capacity,
        read_len_buckets=(tuple(int(x) for x in args.read_len_buckets.split(","))
                          if getattr(args, "read_len_buckets", None) else None),
        mesh_shape=tuple(args.mesh),
        reference_fasta=args.reference,
        extractor=args.extractor,
        json_metrics=args.json_metrics,
        **_accum_kwargs(args),
    )


def _check_multipass_flags(args) -> None:
    """The JAX CLI's rules: a spill IS the multipass partition, so it needs --passes >= 2;
    the host spill and the device store are exclusive; a store holds at least one row."""
    if args.spill_rows is not None and args.spill_rows < 1:
        raise SystemExit(f"--spill-rows must be >= 1 (got {args.spill_rows})")
    if (args.spill is not None or args.spill_rows is not None) and args.passes <= 1:
        raise SystemExit("--spill/--spill-rows require --passes N (N >= 2): "
                         "the spill IS the multipass partition")
    if args.spill is not None and args.spill_rows is not None:
        raise SystemExit("--spill DIR and --spill-rows are exclusive")


def _reject_multipass_flags(args) -> None:
    """`call`-only multipass and spill flags on another subcommand exit non-zero: silently
    ignoring --spill would leave a user believing the single-decode multipass ran."""
    if getattr(args, "passes", 1) > 1:
        raise SystemExit("--passes is only supported by `call` (single-chip WGS path)")
    if getattr(args, "spill", None) or getattr(args, "spill_rows", None) is not None:
        raise SystemExit("--spill/--spill-rows are only supported by `call`")


def cmd_call(args) -> int:
    from denovo_kmer_tpu_torch.parallel import pipeline as sharded
    from denovo_kmer_tpu_torch.pipeline import run_trio, run_trio_multipass, run_trio_spill
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    _check_multipass_flags(args)
    cfg = _cfg_from_args(args)
    on_mesh = cfg.mesh_shape != (1, 1)
    if on_mesh and args.spill is not None:
        raise SystemExit("--spill DIR is the single-chip host spill; with --mesh "
                         "use --spill-rows N (reads-sharded device store)")
    metrics = Metrics(json_stream=sys.stderr if cfg.json_metrics else None)
    trio = (args.mom, args.dad, args.child, cfg)
    region = _resolve_region(args)
    with _profiler(args):
        if args.passes > 1 and on_mesh and args.spill_rows is not None:
            result = sharded.run_trio_spill_sharded(
                *trio, args.passes, device_store_rows=args.spill_rows, metrics=metrics,
                region=region, device=args.device)
        elif args.passes > 1 and (args.spill is not None or args.spill_rows is not None):
            result = run_trio_spill(*trio, args.passes, spill_dir=args.spill,
                                    device_store_rows=args.spill_rows, metrics=metrics,
                                    region=region, device=args.device)
        elif args.passes > 1:
            run = sharded.run_trio_multipass_sharded if on_mesh else run_trio_multipass
            result = run(*trio, args.passes, metrics, region=region, device=args.device)
        elif on_mesh:
            result = sharded.run_trio_sharded(*trio, metrics, region=region,
                                              device=args.device)
        else:
            result = run_trio(*trio, metrics, region=region, device=args.device)

    if args.output_format == "fasta":
        from denovo_kmer_tpu_torch.oracle.scalar import format_fasta

        out_text = format_fasta(result.candidates, cfg.k)
    else:
        out_text = result.report
    if args.output == "-":
        sys.stdout.write(out_text)
    else:
        with open(args.output, "w") as f:
            f.write(out_text)
    print(metrics.summary(), file=sys.stderr)
    print(
        f"candidates: {len(result.candidates)}  "
        f"(uniques mom={result.tables_n['mom']} dad={result.tables_n['dad']} "
        f"child={result.tables_n['child']})",
        file=sys.stderr,
    )
    if args.evidence_out or args.sites_out:
        _evidence_after_call(args, cfg, result)
    return 0


def _evidence_after_call(args, cfg, result) -> None:
    """Right after the call, one more pass over the child for each output asked for: the
    supporting-read subset (``pipeline.run_evidence``) and the per-locus site grouping
    (``sites.group_sites``), each decoding the child again, both from the candidate TSV
    (staged in a temporary file for stdout or FASTA output)."""
    import tempfile

    if args.output != "-" and args.output_format == "tsv":
        tsv = args.output
        tmp = None
    else:
        from denovo_kmer_tpu_torch.oracle.scalar import decode_kmer

        tmp = tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False)
        tmp.write("#kmer\tchild_count\tmom_count\tdad_count\n")
        for v, cc, mc, dc in result.candidates:
            tmp.write(f"{decode_kmer(v, cfg.k)}\t{cc}\t{mc}\t{dc}\n")
        tmp.close()
        tsv = tmp.name
    try:
        if args.evidence_out:
            from denovo_kmer_tpu_torch.pipeline import run_evidence

            ev = run_evidence(args.child, tsv, cfg, args.evidence_out,
                              region=_resolve_region(args), device=args.device)
            print(f"evidence: {ev.n_reads_matched}/{ev.n_reads_scanned} "
                  f"reads -> {ev.out_path}", file=sys.stderr)
        if args.sites_out:
            from denovo_kmer_tpu_torch.sites import group_sites, write_sites_tsv

            sites = group_sites(args.child, tsv, cfg, region=_resolve_region(args),
                                device=args.device)
            write_sites_tsv(sites, args.sites_out)
            print(f"sites: {len(result.candidates)} candidate k-mers -> "
                  f"{len(sites)} loci -> {args.sites_out}", file=sys.stderr)
    finally:
        if tmp is not None:
            os.unlink(tmp.name)


def cmd_sweep(args) -> int:
    """Multi-k sweep (BASELINE.json config 4): one decode pass, per-k tables + reports."""
    from denovo_kmer_tpu_torch.cohort import run_trio_multi_k, run_trio_multi_k_sharded
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    cfg = _cfg_from_args(args)
    try:
        distinct = (args.output_pattern.format(k=1) != args.output_pattern.format(k=2))
    except (KeyError, IndexError, ValueError):
        distinct = False
    if not distinct:
        raise SystemExit(
            "--output-pattern must contain a '{k}' placeholder (e.g. "
            "candidates.k{k}.tsv) — otherwise every k would overwrite the same file"
        )
    _reject_multipass_flags(args)
    ks = [int(x) for x in args.ks.split(",")]
    metrics = Metrics(json_stream=sys.stderr if cfg.json_metrics else None)
    run = run_trio_multi_k_sharded if cfg.mesh_shape != (1, 1) else run_trio_multi_k
    results = run(args.mom, args.dad, args.child, cfg, ks, metrics,
                  region=_resolve_region(args), device=args.device)
    for k, res in sorted(results.items()):
        path = args.output_pattern.format(k=k)
        with open(path, "w") as f:
            f.write(res.report)
        n = res.tables_n
        print(f"k={k}: {len(res.candidates)} candidates -> {path} (uniques mom={n['mom']} "
              f"dad={n['dad']} child={n['child']})", file=sys.stderr)
    print(metrics.summary(), file=sys.stderr)
    return 0


def _trios_from_ped(ped_path: str, sample_map: str, bam_dir: str):
    """Standard 6-column PED (fam iid father mother sex phenotype; '0' = parent unknown) →
    TrioPaths list: one trio per individual with BOTH parents listed. Reads files resolve
    through --sample-map (sample_id<TAB>path) or --bam-dir/<iid>.bam|.cram."""
    from denovo_kmer_tpu_torch.cohort import TrioPaths

    if (sample_map is None) == (bam_dir is None):
        raise SystemExit("--ped needs exactly one of --sample-map or --bam-dir")
    paths = {}
    if sample_map is not None:
        with open(sample_map) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                sid, _, p = line.partition("\t")
                paths[sid] = p

    def resolve(sid: str) -> str:
        if sample_map is not None:
            try:
                return paths[sid]
            except KeyError:
                raise SystemExit(f"--sample-map has no entry for {sid!r}") from None
        for ext in (".bam", ".cram"):
            p = os.path.join(bam_dir, sid + ext)
            if os.path.exists(p):
                return p
        raise SystemExit(f"no {sid}.bam/.cram under {bam_dir!r}")

    trios = []
    with open(ped_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            if len(cols) < 6:
                raise SystemExit(
                    f"{ped_path}:{lineno}: PED needs 6 whitespace-separated "
                    f"columns (fam iid father mother sex phenotype)")
            fam, iid, father, mother = cols[0], cols[1], cols[2], cols[3]
            if father == "0" or mother == "0":
                continue  # founder / single-parent rows are not trios
            trios.append(TrioPaths(
                name=f"{fam}_{iid}",
                mom=resolve(mother), dad=resolve(father), child=resolve(iid),
            ))
    return trios


def cmd_cohort(args) -> int:
    """Cohort mode (BASELINE.json config 5): N trios through one engine.

    Manifest: TSV lines `name<TAB>mom<TAB>dad<TAB>child` (# comments allowed)."""
    from denovo_kmer_tpu_torch.cohort import TrioPaths, run_cohort
    from denovo_kmer_tpu_torch.utils.checkpoint import save_table
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    cfg = _cfg_from_args(args)
    if (args.manifest is None) == (args.ped is None):
        raise SystemExit("cohort needs exactly one of: a manifest, or --ped")
    trios = []
    if args.ped is not None:
        trios = _trios_from_ped(args.ped, args.sample_map, args.bam_dir)
    else:
        with open(args.manifest) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, mom, dad, child = line.split("\t")
                trios.append(TrioPaths(name=name, mom=mom, dad=dad, child=child))
    if not trios:
        raise SystemExit("cohort: no trios found in the input")
    _reject_multipass_flags(args)
    metrics = Metrics(json_stream=sys.stderr if cfg.json_metrics else None)
    os.makedirs(args.outdir, exist_ok=True)
    if cfg.mesh_shape != (1, 1):
        return _cohort_on_mesh(args, cfg, trios, metrics)
    results, superset = run_cohort(trios, cfg, metrics,
                                   build_parental_superset=not args.no_superset,
                                   region=_resolve_region(args), device=args.device)
    for name, res in results.items():
        path = os.path.join(args.outdir, f"{name}.candidates.tsv")
        with open(path, "w") as f:
            f.write(res.report)
        print(f"{name}: {len(res.candidates)} candidates -> {path}", file=sys.stderr)
    if superset is not None:
        sup_path = os.path.join(args.outdir, "parental_superset.npz")
        save_table(sup_path, superset, cfg, source=args.manifest)
        print(f"parental superset: {int(superset.n)} k-mers -> {sup_path}",
              file=sys.stderr)
    print(metrics.summary(), file=sys.stderr)
    return 0


def _cohort_on_mesh(args, cfg, trios, metrics) -> int:
    """`cohort --mesh`: one sharded engine streams all 3N samples; reports from the
    candidate tuples (the same bytes), the superset saved in engine layout by the engine."""
    from denovo_kmer_tpu_torch.cohort import run_cohort_sharded
    from denovo_kmer_tpu_torch.oracle.scalar import format_report

    sup_path = (os.path.join(args.outdir, "parental_superset.npz")
                if not args.no_superset else None)
    results, _superset = run_cohort_sharded(
        trios, cfg, metrics, build_parental_superset=not args.no_superset,
        region=_resolve_region(args), superset_out=sup_path, device=args.device)
    for name, cands in results.items():
        path = os.path.join(args.outdir, f"{name}.candidates.tsv")
        with open(path, "w") as f:
            f.write(format_report(cands, cfg.k))
        print(f"{name}: {len(cands)} candidates -> {path}", file=sys.stderr)
    if sup_path is not None:
        print(f"parental superset -> {sup_path}", file=sys.stderr)
    print(metrics.summary(), file=sys.stderr)
    return 0


def cmd_evidence(args) -> int:
    """The child reads supporting candidate k-mers (the reviewable evidence subset: IGV,
    local reassembly), through the extraction kernel and the candidate probe
    (``pipeline.run_evidence``)."""
    from denovo_kmer_tpu_torch.pipeline import run_evidence

    cfg = _cfg_from_args(args)
    res = run_evidence(args.child, args.candidates, cfg, args.output,
                       region=_resolve_region(args), per_candidate_out=args.per_candidate,
                       device=args.device)
    print(f"evidence: {res.n_reads_matched}/{res.n_reads_scanned} reads -> "
          f"{res.out_path}", file=sys.stderr)
    return 0


def cmd_sites(args) -> int:
    """Candidate-site reporter over an existing candidate TSV (``sites.group_sites``)."""
    from denovo_kmer_tpu_torch.sites import group_sites, write_sites_tsv

    cfg = _cfg_from_args(args)
    sites = group_sites(args.child, args.candidates, cfg, region=_resolve_region(args),
                        device=args.device)
    write_sites_tsv(sites, args.output)
    print(f"sites: {len(sites)} loci -> {args.output}", file=sys.stderr)
    return 0


def cmd_count(args) -> int:
    from denovo_kmer_tpu_torch.pipeline import build_sample_table, build_sample_table_resumable
    from denovo_kmer_tpu_torch.utils.checkpoint import save_table
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    cfg = _cfg_from_args(args)
    metrics = Metrics(json_stream=sys.stderr if cfg.json_metrics else None)
    if (args.region or getattr(args, "regions_bed", None)) and args.resume:
        raise SystemExit("--region and --resume are mutually exclusive")
    _reject_multipass_flags(args)
    with metrics.timer("build"):
        if args.resume:
            if not args.reads.lower().endswith(".bam"):
                raise SystemExit("--resume needs a BAM input (virtual-offset cursor)")
            table = build_sample_table_resumable(
                args.reads, cfg, args.output + ".resume.npz", metrics,
                save_every_flushes=args.ckpt_every, device=args.device)
        else:
            table = build_sample_table(args.reads, cfg, metrics, region=_resolve_region(args),
                                       device=args.device)
    save_table(args.output, table, cfg, source=args.reads)
    print(metrics.summary(), file=sys.stderr)
    print(f"unique k-mers: {int(table.n)} -> {args.output}", file=sys.stderr)
    return 0


def cmd_probe(args) -> int:
    """Query k-mers against a persisted table (the `jellyfish query` analog): k-mers come
    from --kmers (comma-separated) or stdin (one per line); prints `kmer<TAB>count`."""
    import torch

    from denovo_kmer_tpu_torch.ops.table import probe_table
    from denovo_kmer_tpu_torch.oracle.scalar import (
        canonical_value,
        encode_kmer,
        kmer_value_to_words,
    )
    from denovo_kmer_tpu_torch.pipeline import resolve_device
    from denovo_kmer_tpu_torch.utils.checkpoint import load_table

    cfg = _cfg_from_args(args)
    dev = resolve_device(args.device)
    table = load_table(args.table, cfg, device=dev)
    if args.kmers:
        kmer_strs = [s.strip().upper() for s in args.kmers.split(",") if s.strip()]
    else:
        kmer_strs = [line.strip().upper() for line in sys.stdin if line.strip()]
    if not kmer_strs:
        raise SystemExit("no k-mers to query (use --kmers or pipe one per line)")
    words = []
    for s in kmer_strs:
        if len(s) != cfg.k:
            raise SystemExit(f"k-mer {s!r} has length {len(s)}, expected k={cfg.k}")
        v = encode_kmer(s)
        if cfg.canonical:
            v = canonical_value(v, cfg.k)
        words.append(kmer_value_to_words(v, cfg.k))
    counts = probe_table(table, torch.tensor(words, dtype=torch.int64, device=dev)).cpu()
    for s, c in zip(kmer_strs, counts.tolist()):
        print(f"{s}\t{int(c)}")
    return 0


def cmd_index(args) -> int:
    low = args.bam.lower()
    if low.endswith((".fa", ".fasta", ".fna", ".fa.gz", ".fasta.gz", ".fna.gz",
                     ".fa.bgz", ".fasta.bgz", ".fna.bgz")):
        from denovo_kmer_tpu_torch.io.fasta import build_fai

        print(build_fai(args.bam))
        return 0
    if low.endswith((".vcf.gz", ".vcf.bgz")):
        from denovo_kmer_tpu_torch.io.tabix import write_tbi

        print(write_tbi(args.bam))
        return 0
    if low.endswith(".cram"):
        if args.csi:
            raise SystemExit("CSI indexes are BAM-only; CRAM files take a CRAI "
                             "(rerun without --csi)")
        from denovo_kmer_tpu_torch.io.crai import write_crai

        print(write_crai(args.bam))
        return 0
    from denovo_kmer_tpu_torch.io.bai import write_bai, write_csi

    out = write_csi(args.bam) if args.csi else write_bai(args.bam)
    print(out)
    return 0


def cmd_flagstat(args) -> int:
    """Flag-category counts over any reads source (`samtools flagstat` analog)."""
    from denovo_kmer_tpu_torch.pipeline import _record_stream

    cfg = EngineConfig(reference_fasta=args.reference)
    cats = [
        ("total", lambda f: True),
        ("primary", lambda f: not (f & 0x900)),
        ("secondary", lambda f: bool(f & 0x100)),
        ("supplementary", lambda f: bool(f & 0x800)),
        ("duplicates", lambda f: bool(f & 0x400)),
        ("mapped", lambda f: not (f & 0x4)),
        ("paired in sequencing", lambda f: bool(f & 0x1)),
        ("read1", lambda f: (f & 0x41) == 0x41),
        ("read2", lambda f: (f & 0x81) == 0x81),
        ("properly paired", lambda f: (f & 0x3) == 0x3),
        ("singletons", lambda f: (f & 0xD) == 0x9),
        ("QC fail", lambda f: bool(f & 0x200)),
    ]
    counts = [0] * len(cats)
    for rec in _record_stream(args.input, cfg, region=_resolve_region(args)):
        f = rec.flag
        for i, (_n, pred) in enumerate(cats):
            if pred(f):
                counts[i] += 1
    for (name, _), c in zip(cats, counts):
        print(f"{c}\t{name}")
    return 0


def cmd_idxstats(args) -> int:
    """Per-reference mapped/unmapped read counts (`samtools idxstats` analog):
    `name<TAB>length<TAB>#mapped<TAB>#unmapped` per contig plus a trailing
    `*` line with the no-coordinate count. A local BAM with a sibling .bai/.csi
    carrying pseudo-bin metadata answers from the index alone; everything else
    (SAM/CRAM/FASTQ, remote, meta-less index) streams the records."""
    import os

    from denovo_kmer_tpu_torch.pipeline import _record_stream, source_references

    refs = source_references(args.input)
    low = args.input.lower()
    if low.endswith(".bam") and "://" not in args.input:
        from denovo_kmer_tpu_torch.io.bai import index_stats

        for suffix in (".bai", ".csi"):
            p = args.input + suffix
            if os.path.exists(p):
                got = index_stats(p)
                if got is not None:
                    per_ref, n_no_coor = got
                    for (name, length), (m, u) in zip(refs, per_ref):
                        print(f"{name}\t{length}\t{m}\t{u}")
                    print(f"*\t0\t0\t{n_no_coor}")
                    return 0
    cfg = EngineConfig(reference_fasta=args.reference)
    mapped = [0] * len(refs)
    unmapped = [0] * len(refs)
    n_no_coor = 0
    for rec in _record_stream(args.input, cfg):
        refid = getattr(rec, "refid", -1)
        if 0 <= refid < len(refs) and getattr(rec, "pos", -1) >= 0:
            if rec.flag & 0x4:
                unmapped[refid] += 1
            else:
                mapped[refid] += 1
        else:
            n_no_coor += 1
    for (name, length), m, u in zip(refs, mapped, unmapped):
        print(f"{name}\t{length}\t{m}\t{u}")
    print(f"*\t0\t0\t{n_no_coor}")
    return 0


def _coverage_diffs(input_path, refs, cfg, region, exclude_flags):
    """Per-contig coverage diff arrays (+1/-1 per aligned M/=/X interval; one
    cumsum yields per-base depth). Shared by `depth` and `bedcov`. Deletions/
    splices (D/N) span the reference without depositing coverage — samtools
    semantics."""
    import numpy as np

    from denovo_kmer_tpu_torch.pipeline import _record_stream

    diffs = {}
    for rec in _record_stream(input_path, cfg, region=region):
        refid = getattr(rec, "refid", -1)
        if not (0 <= refid < len(refs)) or getattr(rec, "pos", -1) < 0:
            continue
        if rec.flag & 0x4 or rec.flag & exclude_flags:
            continue
        d = diffs.get(refid)
        if d is None:
            d = diffs[refid] = np.zeros(refs[refid][1] + 1, np.int32)
        p = rec.pos
        for n, op in rec.cigar:
            if op in (0, 7, 8):  # M/=/X: aligned bases deposit coverage
                lo, hi = max(p, 0), min(p + n, len(d) - 1)
                if hi > lo:
                    d[lo] += 1
                    d[hi] -= 1
                p += n
            elif op in (2, 3):  # D/N: span the reference, no coverage
                p += n
    return diffs


def cmd_depth(args) -> int:
    """Per-position aligned-base coverage (`samtools depth` analog): lines of
    `ref<TAB>pos1<TAB>depth` for covered positions (all positions with ``-a``)."""
    import numpy as np

    from denovo_kmer_tpu_torch.pipeline import source_references

    refs = source_references(args.input)
    if not refs:
        raise SystemExit("depth: input has no reference dictionary (FASTQ/FASTA?)")
    cfg = EngineConfig(reference_fasta=args.reference)
    region = _resolve_region(args)
    diffs = _coverage_diffs(args.input, refs, cfg, region, args.exclude_flags)
    intervals = {}  # refid -> [(beg0, end0)]: output clips to the restriction
    if region is not None:
        from denovo_kmer_tpu_torch.io.bai import parse_region

        regs = region if isinstance(region, (list, tuple)) else [region]
        for rs in regs:
            rid, b0, e0 = parse_region(rs, refs)
            intervals.setdefault(rid, []).append((b0, e0))
    rids = (
        sorted(intervals) if intervals
        else (range(len(refs)) if args.all else sorted(diffs))
    )
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for refid in rids:
            name, length = refs[refid]
            d = diffs.get(refid)
            cov = (
                np.cumsum(d[:-1]) if d is not None
                else np.zeros(length, np.int32)
            )
            if refid in intervals:
                keep = np.zeros(length, bool)
                for b0, e0 in intervals[refid]:
                    keep[b0:e0] = True
            else:
                keep = np.ones(length, bool)
            if not args.all:
                keep &= cov > 0
            pos0 = np.flatnonzero(keep)
            out.write(
                "".join(f"{name}\t{p + 1}\t{c}\n"
                        for p, c in zip(pos0, cov[pos0]))
            )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_bedcov(args) -> int:
    """Per-BED-region total aligned-base coverage (`samtools bedcov` analog):
    each BED line echoed with the sum of per-base depth over the interval
    appended. One cumsum per touched contig, interval sums via prefix
    differences."""
    import numpy as np

    from denovo_kmer_tpu_torch.io.bai import parse_bed
    from denovo_kmer_tpu_torch.pipeline import source_references

    refs = source_references(args.input)
    if not refs:
        raise SystemExit("bedcov: input has no reference dictionary")
    names = {n: i for i, (n, _) in enumerate(refs)}
    cfg = EngineConfig(reference_fasta=args.reference)
    diffs = _coverage_diffs(args.input, refs, cfg, None, args.exclude_flags)
    prefix = {}  # refid -> cumsum of per-base depth (prefix[i] = sum below i)
    for rid, d in diffs.items():
        prefix[rid] = np.concatenate([[0], np.cumsum(np.cumsum(d[:-1]))])
    for region in parse_bed(args.bed):
        name, _, rng = region.partition(":")
        if name not in names:
            raise SystemExit(f"bedcov: contig {name!r} not in {args.input}")
        rid = names[name]
        b, _, e = rng.replace(",", "").partition("-")
        b0, e0 = int(b) - 1, min(int(e), refs[rid][1])
        pre = prefix.get(rid)
        total = int(pre[e0] - pre[b0]) if pre is not None else 0
        print(f"{name}\t{b0}\t{e0}\t{total}")
    return 0


def cmd_faidx(args) -> int:
    """Fetch FASTA subsequences by region (`samtools faidx` analog): builds the
    .fai on first use, prints each region as a 60-column-wrapped FASTA record.
    Regions are 1-based inclusive `name` or `name:start-end`."""
    from denovo_kmer_tpu_torch.io.fasta import FaidxFasta

    fa = FaidxFasta(args.fasta)
    lengths = fa.lengths()
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for region in args.regions:
            name, _, rng = region.partition(":")
            if name not in fa:
                raise SystemExit(f"faidx: contig {name!r} not in {args.fasta}")
            length = lengths[name]
            if rng:
                b, _, e = rng.replace(",", "").partition("-")
                beg0 = max(int(b) - 1, 0) if b else 0
                end0 = min(int(e), length) if e else length
                if end0 <= beg0:
                    raise SystemExit(f"faidx: empty region {region!r}")
            else:
                beg0, end0 = 0, length
            seq = fa.fetch(name, beg0, end0)
            out.write(f">{region}\n")
            for i in range(0, len(seq), 60):
                out.write(seq[i : i + 60] + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_view(args) -> int:
    """Format conversion + filtering over any reads source (`samtools view`
    analog): BAM/SAM/CRAM in; SAM (default, stdout), BAM, FASTQ or FASTA out;
    --region/--regions-bed restriction; -F flag exclusion; -c count-only.
    CRAM records surface seq/qual/flag (positions are a slice property the
    feeder-grade reader does not retain), so CRAM→BAM/SAM rows are
    sequence-level."""
    from denovo_kmer_tpu_torch.io.bam import BamRecord, BamWriter
    from denovo_kmer_tpu_torch.io.sam import format_sam_record, sam_header_lines
    from denovo_kmer_tpu_torch.pipeline import _record_stream, source_references

    cfg = EngineConfig(reference_fasta=args.reference)
    region = _resolve_region(args)
    recs = _record_stream(args.input, cfg, region=region)
    flt = args.exclude_flags
    stream = (r for r in recs if not (r.flag & flt))
    if args.subsample is not None:
        # samtools -s semantics: keep a deterministic name-hash fraction, so
        # paired records (same name) are kept or dropped together
        import zlib as _z

        frac = args.subsample - int(args.subsample)
        seed = int(args.subsample)
        if frac <= 0:
            raise SystemExit("view -s needs a fractional part, e.g. 42.25")
        cut = int(frac * (1 << 32))

        def _keep(r, i):
            name = getattr(r, "name", None) or f"r{i}"
            return (_z.crc32(f"{seed}:{name}".encode()) & 0xFFFFFFFF) < cut

        stream = (r for i, r in enumerate(stream) if _keep(r, i))

    if args.count:
        print(sum(1 for _ in stream))
        return 0

    out = args.output
    fmt = args.format
    if fmt is None:
        low = (out or "-").lower()
        fmt = ("bam" if low.endswith(".bam") else
               "cram" if low.endswith(".cram") else
               "fastq" if low.endswith((".fastq", ".fq")) else
               "fasta" if low.endswith((".fa", ".fasta")) else "sam")
    refs = source_references(args.input)
    names = [n for n, _ in refs]

    def as_bam_record(r, i):
        if isinstance(r, BamRecord):
            return r
        return BamRecord(name=getattr(r, "name", None) or f"r{i}",
                         flag=getattr(r, "flag", 4) | 4, seq=r.seq, qual=r.qual)

    if fmt == "bam":
        if not out or out == "-":
            raise SystemExit("view: BAM output needs -o FILE (binary stdout)")
        with open(out, "wb") as f, BamWriter(f, references=refs) as w:
            for i, r in enumerate(stream):
                w.write(as_bam_record(r, i))
        return 0

    if fmt == "cram":
        # samtools view -C analog. With --reference: reference-based multiref
        # containers with per-record flags+quals preserved (byte-exact engine
        # view — `call` on the converted file matches the BAM). Without a
        # reference: sequence-archive profile via the BA series, where every
        # record gains the unmapped flag (CRAM unmapped-slice semantics) — the
        # default call filter (SPEC_SEMANTICS §4) skips unmapped reads, so the
        # reference-based form is what conversion pipelines should use.
        if not out or out == "-":
            raise SystemExit("view: CRAM output needs -o FILE (binary stdout)")
        from denovo_kmer_tpu_torch.io.cram import M_GZIP, M_RANSNX16, write_cram
        from denovo_kmer_tpu_torch.pipeline import source_header

        version = (3, 1) if args.cram_version == "3.1" else (3, 0)
        method = M_RANSNX16 if version == (3, 1) else M_GZIP
        hdr = source_header(args.input)[1]
        if refs and "@SQ" not in hdr:
            # the reader maps slice ref ids to FASTA contigs via @SQ names
            hdr = hdr.rstrip("\n") + "\n" + "\n".join(
                sam_header_lines(refs)[1:]) + "\n"
        if args.reference:
            from denovo_kmer_tpu_torch.io.fasta import FaidxFasta

            fa = FaidxFasta(args.reference)
            contigs: dict = {}
            tuples = []
            for i, r in enumerate(stream):
                rec = as_bam_record(r, i)
                placed = 0 <= rec.refid < len(refs) and rec.pos >= 0
                if placed and not (rec.flag & 0x4):
                    rid = rec.refid
                    if rid not in contigs:
                        name = refs[rid][0]
                        if name not in fa:
                            raise SystemExit(
                                f"view: contig {name!r} not in {args.reference}")
                        contigs[rid] = fa[name].upper()
                    tuples.append((rec.seq, rec.pos + 1, rid, rec.flag, rec.qual))
                else:
                    # unmapped (or unplaced) records ride the BA series; BAM
                    # semantics require the flag bit they already carry
                    tuples.append((rec.seq, 0, -1, rec.flag | 0x4, rec.qual))
            write_cram(out, [], sam_header=hdr, mapped=tuples,
                       reference=contigs, version=version, method=method,
                       rans_order=1)
        else:
            print("view: no --reference — writing a sequence-archive CRAM "
                  "(records become flag-unmapped)", file=sys.stderr)
            write_cram(out, ((r.seq, r.qual, r.flag) for r in stream),
                       sam_header=hdr, version=version, method=method,
                       rans_order=1)
        return 0

    fh = sys.stdout if not out or out == "-" else open(out, "w")
    try:
        if fmt == "sam":
            if not args.no_header:
                for ln in sam_header_lines(refs):
                    fh.write(ln + "\n")
            for i, r in enumerate(stream):
                fh.write(format_sam_record(as_bam_record(r, i), names) + "\n")
        elif fmt in ("fastq", "fasta"):
            for i, r in enumerate(stream):
                name = getattr(r, "name", None) or f"r{i}"
                if fmt == "fasta":
                    fh.write(f">{name}\n{r.seq}\n")
                else:
                    q = r.qual if r.qual is not None else (0,) * len(r.seq)
                    qs = "".join(chr(min(x, 93) + 33) for x in q)
                    fh.write(f"@{name}\n{r.seq}\n+\n{qs}\n")
        else:
            raise SystemExit(f"view: unknown --format {fmt!r}")
    finally:
        if fh is not sys.stdout:
            fh.close()
    return 0


def cmd_bgzip(args) -> int:
    """bgzip-compatible block compression: compress to BGZF, -d to inflate,
    -r to (re)build the .gzi random-access index (io/bgzf.py)."""
    from denovo_kmer_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, build_gzi, is_bgzf

    path = args.file
    if args.reindex:
        if not is_bgzf(path):
            raise SystemExit(f"{path} is not BGZF; cannot build a .gzi")
        print(build_gzi(path))
        return 0
    if args.decompress:
        if not path.endswith((".gz", ".bgz")):
            raise SystemExit(f"{path}: expected a .gz/.bgz suffix to strip")
        if not is_bgzf(path):
            raise SystemExit(f"{path} is not BGZF (plain gzip: use gunzip)")
        out = args.output or path.rsplit(".", 1)[0]
        with open(path, "rb") as f, open(out, "wb") as o:
            r = BgzfReader(f)
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                o.write(chunk)
        print(out)
        return 0
    out = args.output or path + ".gz"
    with open(path, "rb") as f, open(out, "wb") as o, BgzfWriter(o) as w:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            w.write(chunk)
    print(out)
    return 0


def cmd_sort(args) -> int:
    from denovo_kmer_tpu_torch.io.bam import sort_bam

    print(sort_bam(args.bam, args.output))
    return 0


def _load_count_table(args, cfg, capacity=None):
    """A `count` checkpoint on ``--device`` (default the card), read back to the host:
    (uint32 keys (n, W), uint32 counts (n,), n)."""
    from denovo_kmer_tpu_torch.ops.table import table_to_numpy
    from denovo_kmer_tpu_torch.utils.checkpoint import load_table

    keys, counts, n = table_to_numpy(load_table(args.table, cfg, capacity=capacity,
                                                device=args.device))
    return keys[:n], counts[:n], n


def cmd_merge(args) -> int:
    """Merge N `count` checkpoints with count addition (`jellyfish merge` analog): one
    device merge per input (``ops/table.merge_tables`` on ``--device``), overflow raises
    with the capacity to use (never drops)."""
    from denovo_kmer_tpu_torch.ops.table import merge_tables
    from denovo_kmer_tpu_torch.pipeline import TableOverflowError, _overflow_msg, resolve_device
    from denovo_kmer_tpu_torch.utils.checkpoint import load_table, save_table

    cfg = _cfg_from_args(args)
    cap = args.table_capacity
    dev = resolve_device(args.device)
    acc = load_table(args.tables[0], cfg, capacity=cap, device=dev)
    for path in args.tables[1:]:
        t = load_table(path, cfg, capacity=cap, device=dev)
        acc = merge_tables(acc, t, cap)
        n = int(acc.n)
        if n > cap:
            raise TableOverflowError(_overflow_msg(n, cap))
    save_table(args.output, acc, cfg)
    print(f"{args.output}\t{int(acc.n)} uniques")
    return 0


def cmd_histo(args) -> int:
    """k-mer multiplicity spectrum of a `count` checkpoint (`jellyfish histo` analog):
    lines of `count<TAB>n_distinct_kmers`, counts above --high fold into the last bin."""
    import numpy as np

    _keys, counts, n = _load_count_table(args, _cfg_from_args(args))
    counts = counts.astype(np.int64)
    if n and counts.min() < 1:
        counts = counts[counts >= 1]  # defensive: padding never counts
    hi = args.high
    clipped = np.minimum(counts, hi)
    hist = np.bincount(clipped, minlength=hi + 1)
    for c in range(args.low, hi + 1):
        if hist[c] or c == hi:
            print(f"{c}\t{int(hist[c])}")
    return 0


def cmd_dump(args) -> int:
    """Dump a `count` checkpoint's k-mers (`jellyfish dump` analog): TSV `kmer<TAB>count`
    (default) or FASTA with the count as the header."""
    from denovo_kmer_tpu_torch.pipeline import decode_kmers_np

    cfg = _cfg_from_args(args)
    keys, counts, n = _load_count_table(args, cfg)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        chunk = 65536  # bounded memory on WGS-scale tables
        for i in range(0, n, chunk):
            strs = decode_kmers_np(keys[i : i + chunk], cfg.k)
            cs = counts[i : i + chunk]
            if args.fasta:
                out.write("".join(f">{int(c)}\n{s}\n" for s, c in zip(strs, cs)))
            else:
                out.write("".join(f"{s}\t{int(c)}\n" for s, c in zip(strs, cs)))
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_stats(args) -> int:
    """Summary stats of a `count` checkpoint (`jellyfish stats` analog): Unique
    (count==1), Distinct, Total, Max_count."""
    import numpy as np

    _keys, counts, n = _load_count_table(args, _cfg_from_args(args))
    counts = counts.astype(np.uint64)
    print(f"Unique:    {int((counts == 1).sum())}")
    print(f"Distinct:  {n}")
    print(f"Total:     {int(counts.sum())}")
    print(f"Max_count: {int(counts.max()) if n else 0}")
    return 0


def cmd_doctor(args) -> int:
    """Environment self-check: torch and its devices, the mesh ``--mesh`` would build,
    the native shim, the CUDA toolchain, codec availability: the first thing to run on a
    new host."""
    import platform

    import torch

    print(f"python      {platform.python_version()} ({platform.machine()})")
    if torch.cuda.is_available():
        kinds: dict = {}
        for i in range(torch.cuda.device_count()):
            name = torch.cuda.get_device_name(i)
            kinds[name] = kinds.get(name, 0) + 1
        devs = ", ".join(f"{n}x {k}" for k, n in kinds.items())
    else:
        devs = "none (CUDA unavailable: run with --device cpu)"
    print(f"torch       {torch.__version__} (CUDA {torch.version.cuda}); devices: {devs}")
    mesh_arg = getattr(args, "mesh", None)
    if mesh_arg and tuple(mesh_arg) != (1, 1):
        # what make_mesh would build: the route all_to_all rides the table axis, so
        # whether it stays inside one process decides the scaling story
        from denovo_kmer_tpu_torch.parallel.mesh import make_mesh, table_axis_ici_local

        try:
            mesh = make_mesh(tuple(mesh_arg), device=args.device)
            loc = ("local (route all_to_all stays inside one process)"
                   if table_axis_ici_local(mesh)
                   else "SPANS processes (route crosses the slow inter-host link — "
                        "prefer a taller reads axis)")
            print(f"mesh        {mesh_arg[0]}x{mesh_arg[1]}: table axis {loc}")
        except (ValueError, RuntimeError) as e:
            print(f"mesh        {mesh_arg[0]}x{mesh_arg[1]}: UNBUILDABLE ({e})")
    try:
        from denovo_kmer_tpu_torch.io.native import native_available

        ok = native_available()
        print(f"C++ shim    {'built (native BGZF/BAM/rANS/arith decode)' if ok else 'not built (pure-Python fallback active)'}")
    except Exception as e:
        print(f"C++ shim    load failed ({e})")
    from denovo_kmer_tpu_torch.utils.cuda_build import _nvcc

    try:
        print(f"nvcc        {_nvcc()} (the CUDA kernels build at first use)")
    except RuntimeError:
        print("nvcc        not found (the CUDA kernels cannot build here)")
    import bz2 as _b, lzma as _l  # noqa: F401  (CRAM codec deps, stdlib)

    print("codecs      BGZF/gzip, bz2, lzma, rANS 4x8, rANS Nx16, arith, "
          "fqzcomp, tok3")
    cfg = EngineConfig()
    print(f"defaults    k={cfg.k} canonical={cfg.canonical} "
          f"flag_mask=0x{cfg.filter_flag_mask:x} table=2^{cfg.table_capacity.bit_length()-1}")
    if getattr(args, "probe_feed", None):
        return _doctor_probe_feed(args)
    return 0


# The card's consumption rate (k-mer windows/s) the feeder must sustain to keep it busy:
# chip_smoke.py phase 4's traced run_trio (k=31, 3 x 262,144 reads of 151 bp, 121 windows
# a read) took 0.0661 s of device-busy time on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit: 1.44e9 windows/s. DENOVO_CHIP_KMERS_PER_SEC overrides it for other cards; read at
# probe time so tests can set it.
_CHIP_DEMAND_DEFAULT = 1.44e9
_CHIP_DEMAND_SOURCE = "measured on an NVIDIA H100 80GB HBM3, 700 W"


def _doctor_probe_feed(args) -> int:
    """Feeder honesty probe: measure this host's decode+pack supply on the EXACT feed path
    ``call`` would take (``pipeline.packed_batches``: the C++ BAM feeder, the columnar CRAM
    feeder, or the pure-Python loop) and compare it with the card's measured demand;
    without this probe nothing at runtime says the feeder is the bottleneck."""
    import time as _t

    import numpy as np

    from denovo_kmer_tpu_torch.pipeline import packed_batches

    path = args.probe_feed
    cfg = EngineConfig(reference_fasta=getattr(args, "reference", None))
    max_batches = max(int(getattr(args, "probe_batches", 8) or 8), 1)
    n_reads = 0
    n_windows = 0
    t0 = _t.perf_counter()
    deadline = t0 + 10.0
    for i, packed in enumerate(packed_batches(path, cfg)):
        n_reads += packed.n_reads
        # windows actually produced (per-read lengths, k-truncated)
        lens = np.asarray(packed.length[: packed.n_reads])
        n_windows += int(np.maximum(lens - cfg.k + 1, 0).sum())
        if i + 1 >= max_batches or _t.perf_counter() > deadline:
            break
    dt = max(_t.perf_counter() - t0, 1e-9)
    supply_reads = n_reads / dt
    supply_kmers = n_windows / dt
    demand = float(os.environ.get("DENOVO_CHIP_KMERS_PER_SEC", _CHIP_DEMAND_DEFAULT))
    cores = os.cpu_count() or 1
    print(f"feed probe  {path}: {supply_reads:,.0f} reads/s, "
          f"{supply_kmers/1e6:.1f} Mk-mers/s supply from {n_reads} reads "
          f"({dt:.2f}s, {cores} core{'s' if cores != 1 else ''})")
    print(f"card demand ~{demand/1e6:.0f} Mk-mers/s/card "
          f"({_CHIP_DEMAND_SOURCE}; DENOVO_CHIP_KMERS_PER_SEC to override)")
    if supply_kmers < demand:
        ratio = demand / max(supply_kmers, 1e-9)
        hint = ""
        if cores == 1:
            hint = " (single-core host: the decode pool needs more cores)"
        elif path.endswith(".cram"):
            hint = (" (CRAM entropy codec may be the cost — arith/fqzcomp decode "
                    "10-20x slower than rANS; consider recoding to rANS or BAM)")
        print(f"WARNING: feeder supplies {1/ratio:.0%} of one card's demand — "
              f"the card will idle {1 - 1/ratio:.0%} of the time{hint}")
        return 1
    print("feeder OK: supply >= one card's demand")
    return 0


def cmd_synth_trio(args) -> int:
    from denovo_kmer_tpu_torch.io.synth import (
        TrioSpec,
        make_trio,
        write_trio_bams,
        write_truth_vcf,
    )

    spec = TrioSpec(
        genome_len=args.genome_len,
        read_len=args.read_len,
        coverage=args.coverage,
        n_denovo_snvs=args.denovo,
        seed=args.seed,
    )
    trio = make_trio(spec)
    paths = write_trio_bams(trio, args.outdir)
    paths["truth_vcf"] = write_truth_vcf(trio, f"{args.outdir}/truth.vcf")
    ref_fa = f"{args.outdir}/ref.fa"
    with open(ref_fa, "w") as f:  # reference-based CRAM workflows need it
        f.write(f">{spec.ref_name}\n")
        for i in range(0, len(trio.reference), 70):
            f.write(trio.reference[i : i + 70] + "\n")
    paths["reference"] = ref_fa
    meta = {
        "paths": paths,
        "denovo_positions": trio.denovo_positions,
        "spec": vars(spec),
    }
    with open(f"{args.outdir}/trio.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(paths))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="denovo_kmer_tpu_torch", description=__doc__)
    p.add_argument("--version", action="version", version="denovo_kmer_tpu_torch 0.1.0")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("call", help="trio de novo candidate calling")
    pc.add_argument("--mom", required=True,
                    help="mother reads (BAM/CRAM/SAM/FASTQ/FASTA, a path or a URL)")
    pc.add_argument("--dad", required=True,
                    help="father reads (BAM/CRAM/SAM/FASTQ/FASTA, a path or a URL)")
    pc.add_argument("--child", required=True)
    pc.add_argument("-o", "--output", default="-")
    pc.add_argument("--evidence-out", default=None,
                    help="also write the child reads supporting any candidate "
                         "to this BAM/SAM/FASTQ (one extra pass; see `evidence`)")
    pc.add_argument("--sites-out", default=None,
                    help="also group overlapping candidate k-mers into loci via "
                         "the evidence reads' positions and write a per-site TSV "
                         "(ref, span, member k-mers, read support)")
    _add_engine_args(pc)
    pc.set_defaults(fn=cmd_call)

    psite = sub.add_parser(
        "sites", help="group an existing candidate TSV into loci using the "
                      "child reads' evidence (candidate-site reporter)")
    psite.add_argument("child", help="child reads (BAM/CRAM/SAM/FASTQ/FASTA)")
    psite.add_argument("candidates", help="candidate TSV from `call`")
    psite.add_argument("-o", "--output", required=True)
    _add_engine_args(psite)
    psite.set_defaults(fn=cmd_sites)

    pw = sub.add_parser("sweep", help="multi-k sweep over one trio (one decode pass)")
    pw.add_argument("--mom", required=True)
    pw.add_argument("--dad", required=True)
    pw.add_argument("--child", required=True)
    pw.add_argument("--ks", default="15,21,31,41",
                    help="comma-separated k values (default %(default)s)")
    pw.add_argument("-o", "--output-pattern", default="candidates.k{k}.tsv",
                    help="per-k output path pattern (default %(default)s)")
    _add_engine_args(pw)
    pw.set_defaults(fn=cmd_sweep)

    ph = sub.add_parser("cohort", help="N trios through one engine")
    ph.add_argument("manifest", nargs="?", default=None,
                    help="TSV: name<TAB>mom<TAB>dad<TAB>child per line (or use --ped)")
    ph.add_argument("--ped", default=None,
                    help="6-column PED pedigree (fam iid father mother sex phenotype); "
                         "every individual with both parents listed becomes a trio. "
                         "Sample files resolve via --sample-map or --bam-dir/<iid>.bam")
    ph.add_argument("--sample-map", default=None,
                    help="TSV: sample_id<TAB>reads_path (with --ped)")
    ph.add_argument("--bam-dir", default=None,
                    help="directory holding <sample_id>.bam (with --ped)")
    ph.add_argument("-o", "--outdir", required=True)
    ph.add_argument("--no-superset", action="store_true",
                    help="skip the cohort parental superset table")
    _add_engine_args(ph)
    ph.set_defaults(fn=cmd_cohort)

    pe = sub.add_parser(
        "evidence", help="write the child reads containing any candidate k-mer "
                         "(forward or reverse complement) to a BAM, SAM or FASTQ")
    pe.add_argument("--child", required=True, help="child reads (BAM/CRAM/SAM/FASTQ/FASTA)")
    pe.add_argument("--candidates", required=True,
                    help="candidate TSV from `call` (first column = k-mer)")
    pe.add_argument("-o", "--output", required=True,
                    help="output path (.bam, .sam, or .fastq/.fq)")
    pe.add_argument("--per-candidate", default=None,
                    help="also write a TSV mapping each candidate k-mer to its "
                         "supporting read names")
    _add_engine_args(pe)
    pe.set_defaults(fn=cmd_evidence)

    pk = sub.add_parser("count", help="build and persist one sample's k-mer table")
    pk.add_argument("reads")
    pk.add_argument("-o", "--output", required=True)
    pk.add_argument("--resume", action="store_true",
                    help="mid-pass resume via <output>.resume.npz (table + BAM cursor)")
    pk.add_argument("--ckpt-every", type=int, default=4,
                    help="flushes between resume checkpoints (default %(default)s)")
    _add_engine_args(pk)
    pk.set_defaults(fn=cmd_count)

    pq = sub.add_parser("probe", help="query k-mer counts in a `count` table checkpoint")
    pq.add_argument("table", help="table checkpoint (.npz from `count`)")
    pq.add_argument("--kmers", default=None,
                    help="comma-separated k-mers (default: read one per line from stdin)")
    _add_engine_args(pq)
    pq.set_defaults(fn=cmd_probe)

    pf = sub.add_parser("flagstat",
                        help="flag-category counts (samtools flagstat analog)")
    pf.add_argument("input")
    pf.add_argument("--region", default=None)
    pf.add_argument("--regions-bed", default=None)
    pf.add_argument("--reference", default=None)
    pf.set_defaults(fn=cmd_flagstat)

    pdr = sub.add_parser("doctor", help="environment self-check: devices, "
                                        "native shim, codecs; --probe-feed "
                                        "measures feeder supply vs card demand")
    pdr.add_argument("--probe-feed", default=None, metavar="READS",
                     help="BAM/CRAM file: measure this host's decode+pack rate on "
                          "the production feed path and warn if it cannot keep one "
                          "card busy (exit 1 on warning)")
    pdr.add_argument("--probe-batches", type=int, default=8,
                     help="batches to time in the feed probe (default 8)")
    pdr.add_argument("--mesh", type=_mesh_shape, default=(1, 1),
                     help="also report the READSxTABLE mesh make_mesh would "
                          "build and whether its table axis stays inside one process")
    pdr.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where --mesh draws its devices (default: the CUDA cards)")
    pdr.add_argument("--reference", default=None,
                     help="reference FASTA for reference-based CRAM probe input")
    pdr.set_defaults(fn=cmd_doctor)

    px = sub.add_parser(
        "idxstats", help="per-reference mapped/unmapped counts "
                         "(samtools idxstats analog; index fast path)")
    px.add_argument("input")
    px.add_argument("--reference", default=None,
                    help="reference FASTA for reference-based CRAM input")
    px.set_defaults(fn=cmd_idxstats)

    pdp = sub.add_parser(
        "depth", help="per-position aligned-base coverage "
                      "(samtools depth analog)")
    pdp.add_argument("input")
    pdp.add_argument("-o", "--output", default="-")
    pdp.add_argument("-a", "--all", action="store_true",
                     help="print zero-coverage positions too")
    pdp.add_argument("-F", "--exclude-flags", type=_int_maybe_hex,
                     default=0x700,  # samtools default: unmap/secondary/qcfail/dup
                     help="drop records with any of these flag bits (hex ok)")
    pdp.add_argument("--region", default=None)
    pdp.add_argument("--regions-bed", default=None)
    pdp.add_argument("--reference", default=None,
                     help="reference FASTA for reference-based CRAM input")
    pdp.set_defaults(fn=cmd_depth)

    pbc = sub.add_parser(
        "bedcov", help="per-BED-region total aligned-base coverage "
                       "(samtools bedcov analog)")
    pbc.add_argument("bed", help="BED3+ file of regions")
    pbc.add_argument("input")
    pbc.add_argument("-F", "--exclude-flags", type=_int_maybe_hex,
                     default=0x700,
                     help="drop records with any of these flag bits (hex ok)")
    pbc.add_argument("--reference", default=None,
                     help="reference FASTA for reference-based CRAM input")
    pbc.set_defaults(fn=cmd_bedcov)

    pst = sub.add_parser(
        "stats", help="summary stats of a `count` checkpoint "
                      "(jellyfish stats analog)")
    pst.add_argument("table", help="table checkpoint (.npz from `count`)")
    _add_engine_args(pst)
    pst.set_defaults(fn=cmd_stats)

    pfa = sub.add_parser(
        "faidx", help="fetch FASTA subsequences by region "
                      "(samtools faidx analog; builds .fai on first use)")
    pfa.add_argument("fasta")
    pfa.add_argument("regions", nargs="+",
                     help="1-based inclusive `name` or `name:start-end`")
    pfa.add_argument("-o", "--output", default="-")
    pfa.set_defaults(fn=cmd_faidx)

    pv = sub.add_parser(
        "view", help="convert/filter reads (samtools view analog): BAM/SAM/CRAM "
                     "in, SAM/BAM/FASTQ/FASTA out, region + flag filters")
    pv.add_argument("input")
    pv.add_argument("-o", "--output", default="-")
    pv.add_argument("--format", choices=("sam", "bam", "cram", "fastq", "fasta"),
                    default=None, help="default: by -o extension, else SAM")
    pv.add_argument("--cram-version", choices=("3.0", "3.1"), default="3.0",
                    help="CRAM output version (3.1 uses rANS Nx16 blocks)")
    pv.add_argument("-F", "--exclude-flags", type=_int_maybe_hex, default=0,
                    help="drop records with any of these flag bits (hex ok)")
    pv.add_argument("-c", "--count", action="store_true",
                    help="print the record count only")
    pv.add_argument("-s", "--subsample", type=float, default=None,
                    help="SEED.FRACTION (samtools -s): keep a deterministic "
                         "name-hash fraction of the reads, e.g. 42.25")
    pv.add_argument("--no-header", action="store_true",
                    help="omit the SAM header lines")
    pv.add_argument("--region", default=None)
    pv.add_argument("--regions-bed", default=None)
    pv.add_argument("--reference", default=None,
                    help="reference FASTA for reference-based CRAM input")
    pv.set_defaults(fn=cmd_view)

    pm = sub.add_parser(
        "merge", help="merge `count` checkpoints with count addition "
                      "(jellyfish merge analog)")
    pm.add_argument("tables", nargs="+", help="input .npz checkpoints")
    pm.add_argument("-o", "--output", required=True)
    _add_engine_args(pm)
    pm.set_defaults(fn=cmd_merge)

    pt = sub.add_parser(
        "histo", help="k-mer multiplicity spectrum of a `count` checkpoint "
                      "(jellyfish histo analog)")
    pt.add_argument("table", help="table checkpoint (.npz from `count`)")
    pt.add_argument("--low", type=int, default=1)
    pt.add_argument("--high", type=int, default=10_000,
                    help="counts above this fold into the last bin")
    _add_engine_args(pt)
    pt.set_defaults(fn=cmd_histo)

    pd = sub.add_parser(
        "dump", help="dump a `count` checkpoint's k-mers to TSV or FASTA "
                     "(jellyfish dump analog)")
    pd.add_argument("table", help="table checkpoint (.npz from `count`)")
    pd.add_argument("-o", "--output", default="-")
    pd.add_argument("--fasta", action="store_true",
                    help="FASTA with the count as each record's header")
    _add_engine_args(pd)
    pd.set_defaults(fn=cmd_dump)

    pb = sub.add_parser(
        "bgzip", help="block-compress a file to BGZF (bgzip-compatible); "
                      "-d inflates, -r builds the .gzi random-access index",
    )
    pb.add_argument("file")
    pb.add_argument("-d", "--decompress", action="store_true")
    pb.add_argument("-r", "--reindex", action="store_true",
                    help="write <file>.gzi (block index for random access)")
    pb.add_argument("-o", "--output", default=None)
    pb.set_defaults(fn=cmd_bgzip)

    pi = sub.add_parser(
        "index", help="write a BAI/CSI index for a coordinate-sorted BAM, "
                      "a CRAI for a CRAM, a FAI for a FASTA, or a TBI for a "
                      "bgzipped VCF"
    )
    pi.add_argument("bam")
    pi.add_argument("--csi", action="store_true", help="write .csi instead of .bai")
    pi.set_defaults(fn=cmd_index)

    po = sub.add_parser("sort", help="coordinate-sort a BAM (fixture/subset scale)")
    po.add_argument("bam")
    po.add_argument("-o", "--output", required=True)
    po.set_defaults(fn=cmd_sort)

    ps = sub.add_parser("synth-trio", help="generate a synthetic trio fixture")
    ps.add_argument("outdir")
    ps.add_argument("--genome-len", type=int, default=20000)
    ps.add_argument("--read-len", type=int, default=100)
    ps.add_argument("--coverage", type=float, default=12.0)
    ps.add_argument("--denovo", type=int, default=5)
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_synth_trio)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # `... | head` closes stdout mid-stream; exit quietly like samtools
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
