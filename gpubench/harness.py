"""One run of one cell: reads made from the seed, a warm-up trio, a window of whole trios
through the port's entry, the per-layer readings of a traced run, and the check against the
plain reference.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the port's entry, its flags as ``call`` / ``sweep`` take them) and
a traffic mix (``traffic/<name>.json``: the reads and the route). A metric is read by
``metrics/<name>.py``'s ``read(run)``, which returns None where the run has nothing to read.

The reads enter the port at its decode seam, ``packed_batches(source, cfg, region)``: for
the run, ``pipeline.packed_batches`` and ``cohort.packed_batches`` are bound to a source
that yields a sample's pre-decoded batches for the sample's sentinel path and refuses any
other path. After each trio the port's ``reads_ingested`` must equal the reads made, sample
by sample, so a run whose reads took another path fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import inspect
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from gpubench import reads as reads_mod
from gpubench import reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "denovo_kmer_tpu_torch"
#: modules whose ``packed_batches`` name the port's entries call
SEAM_MODULES = ("pipeline", "cohort")
#: batches a sample in the warm-up trio
WARM_BATCHES = 4
#: the prefix of a sample's sentinel path (neither .bam nor .npz)
SENTINEL = "gpubench-reads:"


def log(*parts) -> None:
    print("gpubench:", *parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics: List[dict]  # BENCHMARK.json metric entries this run reports
    chips: int = 1


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, trace: bool, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, with the metrics that a run
    with (``trace``) or without tracing reports in it."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if workload in m.get("workloads", [workload])]
    return Cell(workload, config, traffic, metrics, w["chips"])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------------------
# the port's configuration, entry and feed seam
# ---------------------------------------------------------------------------------------

def engine_args(config: dict, traffic: dict, device: str, spill_rows=None):
    """The flags of ``call`` / ``sweep`` as the port's CLI parses them."""
    from denovo_kmer_tpu_torch import cli

    p = argparse.ArgumentParser(add_help=False)
    cli._add_engine_args(p)
    p.add_argument("--ks", default=None)
    route = traffic["route"]
    argv = [*config["flags"], "--table-capacity", str(route["table_capacity"]),
            "--passes", str(route.get("passes", 1)), "--device", device]
    if spill_rows is not None:
        argv += ["--spill-rows", str(spill_rows)]
    return p.parse_args(argv)


def run_ks(args) -> List[int]:
    return [int(x) for x in args.ks.split(",")] if args.ks else [args.kmer_size]


def entry_of(config: dict):
    module, _, name = config["entry"].rpartition(".")
    return getattr(importlib.import_module(f"{PORT}.{module}"), name)


def call_entry(entry, paths: dict, cfg, args, metrics, device) -> dict:
    """One trio through ``entry`` → {k: TrioResult}. The entry's parameters after the three
    paths and the config are taken by name from what the flags give."""
    offer = {"ks": run_ks(args), "n_passes": args.passes,
             "device_store_rows": args.spill_rows, "metrics": metrics, "device": device}
    params = inspect.signature(entry).parameters
    kwargs = {k: v for k, v in offer.items() if k in params}
    out = entry(paths["mom"], paths["dad"], paths["child"], cfg, **kwargs)
    return out if isinstance(out, dict) else {cfg.k: out}


class ReadSource:
    """The feed seam's stand-in: ``packed_batches(source, cfg, region)`` over pre-decoded
    samples, each under its sentinel path. It records the port's ``reads_ingested`` at
    each call, so that ``check`` can tell each sample's reads were counted."""

    def __init__(self, samples: List[reads_mod.SampleReads], batch_reads: int,
                 words_per_row: int):
        self.samples = {SENTINEL + s.name: s for s in samples}
        self.batch_reads = batch_reads
        self.words_per_row = words_per_row
        self.metrics = None
        self.calls: List[tuple] = []

    def paths(self) -> Dict[str, str]:
        return {s.name: p for p, s in self.samples.items()}

    def __call__(self, source, cfg, region=None):
        if not isinstance(source, str) or source not in self.samples:
            raise ValueError(f"gpubench's feed has no reads under {source!r}")
        if region is not None:
            raise ValueError("gpubench's feed has no regions")
        if (cfg.batch_reads != self.batch_reads
                or reads_mod.padded_length(cfg.max_read_len) // 16 != self.words_per_row):
            raise ValueError("the port asked for batches of another shape than were made")
        self.calls.append((source, self.metrics.counters["reads_ingested"]))
        return (b for b in self.samples[source].batches)  # a generator, as the port's are

    def check(self) -> None:
        """Each sample fed once, and each sample's reads counted by the port; clears."""
        done = self.calls + [(None, self.metrics.counters["reads_ingested"])]
        fed = {}
        for (path, before), (_p, after) in zip(done, done[1:]):
            if path in fed:
                raise RuntimeError(f"the port read {path} twice in one trio")
            fed[path] = after - before
        want = {p: s.n_reads for p, s in self.samples.items()}
        if fed != want:
            raise RuntimeError(f"the port's reads_ingested {fed} != the reads made {want}: "
                               "its reads did not all come through packed_batches")
        self.calls = []


@contextlib.contextmanager
def seam_bound(source: ReadSource):
    """``packed_batches`` of the seam modules bound to ``source``, restored on exit."""
    mods = [importlib.import_module(f"{PORT}.{m}") for m in SEAM_MODULES]
    saved = [m.packed_batches for m in mods]  # AttributeError: the seam moved
    for m in mods:
        m.packed_batches = source
    try:
        yield source
    finally:
        for m, real in zip(mods, saved):
            m.packed_batches = real


# ---------------------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------------------

@dataclasses.dataclass
class Trio:
    seconds: float
    reads: int
    metrics: object  # the port's Metrics
    results: dict  # {k: TrioResult}
    launches: int


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    trios: List[Trio]
    window_peak_bytes: Optional[int] = None
    probe: Optional[object] = None  # probes.Probe of a traced run
    trace: Optional[dict] = None  # trace.summarize of a traced run


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launches() -> int:
    from denovo_kmer_tpu_torch.ops.extract import extract_append

    return extract_append.launches


def run_trio(entry, source: ReadSource, cfg, args, device) -> Trio:
    from denovo_kmer_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    source.metrics = m
    n0 = _launches()
    t0 = time.perf_counter()
    with torch.profiler.record_function("trio"):
        results = call_entry(entry, source.paths(), cfg, args, m, device)
        _sync(device)
    seconds = time.perf_counter() - t0
    source.check()
    reads = sum(s.n_reads for s in source.samples.values())
    return Trio(seconds, reads, m, results, _launches() - n0)


def window(entry, source: ReadSource, cfg, args, device, seconds: float) -> tuple:
    """Whole trios back to back: a further trio starts only where the time elapsed and the
    last trio's time fit in ``seconds``; at least one. → (trios, window seconds)."""
    trios: List[Trio] = []
    t0 = time.perf_counter()
    while True:
        trio = run_trio(entry, source, cfg, args, device)
        trios.append(trio)
        elapsed = time.perf_counter() - t0
        steps = ", ".join(f"{k} {v:.3f}" for k, v in sorted(trio.metrics.seconds.items()))
        log(f"trio {len(trios)}: {trio.seconds:.4f} s, {trio.launches} extraction launches; "
            f"the port's seconds: {steps}")
        if elapsed + trio.seconds > seconds:
            return trios, elapsed


def make_reads(cell: Cell, seed: int, args, device) -> List[reads_mod.SampleReads]:
    from denovo_kmer_tpu_torch.ops.pack import PackedReads

    spec = reads_mod.ReadSpec(**cell.traffic["reads"])
    ks = run_ks(args) if cell.traffic["route"].get("spill_slack") else ()
    return reads_mod.make_trio(spec, seed, device, args.batch_reads, args.max_read_len, ks,
                               PackedReads)


def reference_answers(cell: Cell, seed: int, args, cfg, device, fingerprint=False) -> dict:
    """{k: reference.TrioAnswer} from the reads made anew on ``device``; with
    ``fingerprint`` the control's answers."""
    spec = reads_mod.ReadSpec(**cell.traffic["reads"])
    haps = reads_mod.haplotypes(spec, seed, device)
    out = {}
    for k in run_ks(args):
        t0 = time.perf_counter()
        out[k] = reference.trio_answer(
            lambda s: reads_mod.sample_chunks(spec, seed, s, haps[s]), k, cfg.canonical,
            cfg.max_read_len, cfg.tau_parent, cfg.min_child_count,
            reference.control_bits(k) if fingerprint else None)
        _sync(device)
        log(f"{'control' if fingerprint else 'reference'} k={k}: "
            f"{time.perf_counter() - t0:.2f} s, {len(out[k].child)} candidates, "
            f"tables_n {out[k].tables_n}")
    return out


def _rows_off(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


#: the numbers compared at each k; every comparison is exact, so each limit is 0
CHECKS = ("report_rows_off", "candidates_off", "mom_n_off", "dad_n_off", "child_n_off")


def _view(answer) -> tuple:
    """(report, candidate rows, tables_n) of a TrioResult or a reference.TrioAnswer."""
    if isinstance(answer, reference.TrioAnswer):
        return answer.report(), answer.rows(), answer.tables_n
    return answer.report, answer.candidates, answer.tables_n


def compare(answers: Dict[int, object], results: List[dict]) -> tuple:
    """Each of ``results`` ({k: TrioResult} a trio, or the control's {k: TrioAnswer})
    against the reference's ``answers`` → ({name: [the largest reading, its limit]}, the
    results that miss a limit)."""
    ref = {k: (a.report().split("\n"), a.rows(), a.tables_n) for k, a in answers.items()}
    numbers = {f"k{k}_{c}": [0, 0] for k in answers for c in CHECKS}
    failed = 0
    last: dict = {}
    for res in results:
        bad = False
        for k, (ref_lines, ref_rows, ref_n) in ref.items():
            if k in res:
                report, rows, tables_n = _view(res[k])
            else:  # a lane the entry did not answer
                report, rows, tables_n = "", [], {s: 0 for s in ref_n}
            prev = last.get(k)
            if prev is not None and prev[0] == report and prev[1] == rows:
                offs = dict(prev[2])
            else:
                offs = {"report_rows_off": _rows_off(report.split("\n"), ref_lines),
                        "candidates_off": _rows_off(rows, ref_rows)}
                last[k] = (report, rows, dict(offs))
            for s in ("mom", "dad", "child"):
                offs[f"{s}_n_off"] = abs(int(tables_n[s]) - int(ref_n[s]))
            for name, v in offs.items():
                number = numbers[f"k{k}_{name}"]
                number[0] = max(number[0], v)
                bad |= v > number[1]
        failed += bad
    return numbers, failed


def device_info(device, count: int, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """One run of ``cell`` → the result object, its last key ``check``. ``t_start`` is when
    set-up began (the process's start; by default now)."""
    from gpubench import probes
    from gpubench import trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
    t_reads = time.perf_counter()
    args = engine_args(cell.config, cell.traffic, device)
    samples = make_reads(cell, seed, args, device)
    _sync(device)
    t_cfg = time.perf_counter()
    route = cell.traffic["route"]
    rows = reads_mod.spill_rows(samples, run_ks(args)[0], args.passes,
                                route.get("spill_slack"))
    if rows is not None:
        args = engine_args(cell.config, cell.traffic, device, rows)
    from denovo_kmer_tpu_torch import cli

    cfg = cli._cfg_from_args(args)
    entry = entry_of(cell.config)
    words = reads_mod.padded_length(cfg.max_read_len) // 16
    log(f"{cell.name}: entry {cell.config['entry']}, ks {run_ks(args)}, "
        f"{cfg.accum_batches} batches a window, table capacity {cfg.table_capacity}, "
        f"{samples[0].n_reads} reads a sample in {len(samples[0].batches)} batches")
    warm = ReadSource([reads_mod.first_batches(s, WARM_BATCHES) for s in samples],
                      cfg.batch_reads, words)
    t_warm = time.perf_counter()
    with seam_bound(warm):
        run_trio(entry, warm, cfg, args, device)
    log(f"set-up: imports and CUDA start {t_reads - t_start:.3f} s, reads "
        f"{t_cfg - t_reads:.3f} s, plan {t_warm - t_cfg:.3f} s, warm trio "
        f"{time.perf_counter() - t_warm:.3f} s")
    source = ReadSource(samples, cfg.batch_reads, words)
    gc.collect()
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    probe = probes.Probe(device) if trace else None
    with seam_bound(source), (probe.installed() if trace else contextlib.nullcontext()), \
            (trace_mod.Recorder(device) if trace else contextlib.nullcontext()) as rec:
        setup_s = time.perf_counter() - t_start
        trios, window_s = window(entry, source, cfg, args, device, seconds)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(setup_s, window_s, trios, window_peak, probe,
              rec.summary() if trace else None)
    if trace:
        probe.finish()
    log(f"window {window_s:.4f} s, {len(trios)} trios, set-up {setup_s:.4f} s, "
        f"window peak {window_peak / 1e9:.3f} GB")
    metrics = {}
    for m in cell.metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    results = [t.results for t in trios]
    del samples, source, warm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, failed = compare(reference_answers(cell, seed, args, cfg, device), results)
    log(f"check: {time.perf_counter() - t0:.2f} s")
    out = {"correct": failed == 0 and bool(trios), "attempted": len(trios),
           "failed": failed, "metrics": metrics,
           "device": device_info(device, 1, max(setup_peak, window_peak))}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["check"] = numbers
    return out
