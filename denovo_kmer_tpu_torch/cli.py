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
    synth-trio  generate a deterministic synthetic trio (test/bench fixture)

Reads come from BAM, CRAM (3.0/3.1; ``--reference`` for reference-based CRAM), SAM (plain or
gzip), FASTQ or FASTA, as local paths or ``http(s)://``, ``s3://`` and ``gs://`` URLs.
``--region chr20:1-2,000`` (BAM through its .bai/.csi, CRAM through its .crai, a full-scan
filter without an index) or ``--regions-bed`` (BAM) restricts the reads.
``--read-len-buckets 64,112,160`` packs and extracts each read at the smallest width that
holds it; ``--ingest-threads N`` sets the C++ BAM feeder's decode threads; ``call
--profile-dir DIR`` writes a ``torch.profiler`` Chrome trace. ``--mesh RxT`` runs ``call`` (plain,
``--passes N``, ``--passes N --spill-rows N``), ``sweep`` and ``cohort`` on the sharded engine
over an R x T mesh: R·T cards, or with ``--device cpu`` R·T copies of the CPU; the other
subcommands accept the flag and ignore it, as the JAX CLI does.
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


def _accum_kwargs(args) -> dict:
    """--accum-batches: integer, or 'auto' = size the accumulation window from the
    device's memory: staging costs batch_reads * windows_per_read * (4*words+1) B per
    batch and the flush sort needs a few times that, so auto budgets ~15% of memory."""
    raw = args.accum_batches
    if str(raw) != "auto":
        return {"accum_batches": int(raw)}
    import torch

    if args.device == "cuda" and torch.cuda.is_available():
        mem = torch.cuda.get_device_properties(0).total_memory
    else:
        mem = 4 << 30
    P = args.max_read_len - args.kmer_size + 1
    words = -(-2 * args.kmer_size // 32)
    per_batch = args.batch_reads * P * (4 * words + 1)
    # staging splits over the mesh: each shard holds 1/(R*T) of a batch
    reads_ax, table_ax = args.mesh
    per_batch = -(-per_batch // max(reads_ax * table_ax, 1))
    n = min(max(int(mem * 0.15 / max(per_batch, 1)), 8), 128)
    print(f"accum auto: {n} batches/window "
          f"({n * per_batch / 1e9:.2f} GB staging of {mem / 1e9:.0f} GB)", file=sys.stderr)
    return {"accum_batches": n}


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
        print(f"k={k}: {len(res.candidates)} candidates -> {path}", file=sys.stderr)
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
