"""The port's table checkpoints and resumable build (denovo_kmer_tpu_torch/utils/checkpoint.py,
pipeline.build_sample_table_resumable, the `count` and `probe` subcommands, `.npz` parents in
the trio paths) against the JAX package: checkpoint files load in both directions, resumed
builds are bit-identical, `count` writes the JAX CLI's arrays and meta, `probe` prints its
stdout byte for byte, and trio reports with `.npz` parents equal JAX's. Tolerance 0."""

import io
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from denovo_kmer_tpu import cli as jax_cli
from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.pipeline import build_sample_table as jax_build_sample_table
from denovo_kmer_tpu.pipeline import build_sample_table_resumable as jax_resumable
from denovo_kmer_tpu.pipeline import packed_stream_with_cursor as jax_cursor_stream
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu.pipeline import run_trio_multipass as jax_run_trio_multipass
from denovo_kmer_tpu.pipeline import run_trio_spill as jax_run_trio_spill
from denovo_kmer_tpu.utils import checkpoint as jax_ckpt
from denovo_kmer_tpu_torch import cli
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io import native
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops.table import table_to_numpy
from denovo_kmer_tpu_torch.pipeline import (
    build_sample_table,
    build_sample_table_resumable,
    packed_stream_with_cursor,
    run_trio,
    run_trio_multipass,
    run_trio_spill,
)
from denovo_kmer_tpu_torch.utils import checkpoint as ckpt
from denovo_kmer_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

# the fixture of tests/test_resume.py, and a config with several flushes a sample
SPEC = dict(genome_len=2500, read_len=50, coverage=6.0, seed=17, n_denovo_snvs=3)
CFG = dict(k=21, max_read_len=64, batch_reads=32, table_capacity=1 << 13, accum_batches=2)
CLI_CFG = ["-k", "21", "--max-read-len", "64", "--batch-reads", "32", "--table-capacity",
           str(1 << 13), "--accum-batches", "2"]


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_trio")
    return write_trio_bams(make_trio(TrioSpec(**SPEC)), str(d))


@pytest.fixture(scope="module")
def jax_tables(trio, tmp_path_factory):
    """The JAX package's `count` checkpoints of both parents."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    cfg = JaxConfig(**CFG)
    out = {}
    for s in ("mom", "dad"):
        out[s] = str(d / f"{s}.npz")
        jax_ckpt.save_table(out[s], jax_build_sample_table(trio[s], cfg), cfg, source=trio[s])
    return out


def _arrays(path):
    with np.load(path) as z:
        return z["keys"], z["counts"], json.loads(bytes(z["meta"]).decode())


def _same_table(port_table, jax_table):
    keys, counts, n = table_to_numpy(port_table)
    assert n == int(jax_table.n)
    np.testing.assert_array_equal(keys, np.asarray(jax_table.keys))
    np.testing.assert_array_equal(counts, np.asarray(jax_table.counts))


def test_jax_checkpoint_loads_in_the_port(jax_tables):
    cfg, jcfg = EngineConfig(**CFG), JaxConfig(**CFG)
    for s, path in jax_tables.items():
        _same_table(ckpt.load_table(path, cfg, device="cpu"), jax_ckpt.load_table(path, jcfg))
        assert ckpt.table_meta(path) == jax_ckpt.table_meta(path)


def test_port_checkpoint_loads_in_jax(trio, tmp_path):
    cfg, jcfg = EngineConfig(**CFG), JaxConfig(**CFG)
    table = build_sample_table(trio["mom"], cfg, device="cpu")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_table(ours, table, cfg, source=trio["mom"])
    jax_ckpt.save_table(theirs, jax_build_sample_table(trio["mom"], jcfg), jcfg,
                        source=trio["mom"])
    _same_table(table, jax_ckpt.load_table(ours, jcfg))
    for a, b in zip(_arrays(ours), _arrays(theirs)):
        if isinstance(a, dict):
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_semantics_mismatch_raises(jax_tables, trio, tmp_path, direction):
    other = dict(CFG, min_base_quality=20)  # a semantic knob: another config hash
    if direction == "jax_to_port":
        with pytest.raises(ckpt.CheckpointError, match="semantics mismatch"):
            ckpt.load_table(jax_tables["mom"], EngineConfig(**other), device="cpu")
    else:
        path = str(tmp_path / "t.npz")
        cfg = EngineConfig(**CFG)
        ckpt.save_table(path, build_sample_table(trio["dad"], cfg, device="cpu"), cfg)
        with pytest.raises(jax_ckpt.CheckpointError, match="semantics mismatch"):
            jax_ckpt.load_table(path, JaxConfig(**other))


def test_capacity_and_resume_guards(jax_tables, tmp_path):
    cfg = EngineConfig(**CFG)
    with pytest.raises(ckpt.CheckpointError, match="capacity"):
        ckpt.load_table(jax_tables["mom"], cfg, capacity=16, device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="not a resume checkpoint"):
        ckpt.load_resume(jax_tables["mom"], cfg, device="cpu")
    assert ckpt.maybe_load_flat_table("x.bam", cfg) is None


def test_loads_default_to_the_card(jax_tables, monkeypatch):
    """``device=None`` is the card, as at every entry point of the port: without one the
    loads raise instead of handing back a host table; the table lands where it was asked."""
    cfg = EngineConfig(**CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (ckpt.load_table, ckpt.maybe_load_flat_table, ckpt.load_resume):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            load(jax_tables["mom"], cfg)
    table = ckpt.maybe_load_flat_table(jax_tables["mom"], cfg, device="cpu")
    assert table.keys.device.type == "cpu" and int(table.n) > 0


@pytest.mark.parametrize("feeder", ["native", "python"])
def test_cursor_stream_matches_jax_and_replays(trio, monkeypatch, feeder):
    if feeder == "python":
        monkeypatch.setattr(native, "native_available", lambda: False)
    cfg = EngineConfig(**CFG)
    batches = list(packed_stream_with_cursor(trio["child"], cfg))
    want = list(jax_cursor_stream(trio["child"], JaxConfig(**CFG)))
    assert len(batches) == len(want) >= 4
    for (p, off), (q, qoff) in zip(batches, want):
        assert off == qoff
        np.testing.assert_array_equal(p.words, q.words)
        np.testing.assert_array_equal(p.vwords, q.vwords)
    stream = packed_stream_with_cursor(trio["child"], cfg)
    stream.seek(batches[1][1])
    rest = list(stream)
    stream.close()
    assert len(rest) == len(batches) - 2
    for (p, off), (q, qoff) in zip(batches[2:], rest):
        np.testing.assert_array_equal(p.words, q.words)
        assert off == qoff


@pytest.mark.parametrize("feeder", ["native", "python"])
def test_interrupted_build_resumes_bit_identical(trio, tmp_path, monkeypatch, feeder):
    if feeder == "python":
        monkeypatch.setattr(native, "native_available", lambda: False)
    cfg = EngineConfig(**CFG)
    golden = jax_build_sample_table(trio["child"], JaxConfig(**CFG))
    resume_path = str(tmp_path / "child.resume.npz")

    class Boom(RuntimeError):
        pass

    saves = []
    real_save = ckpt.save_resume

    def crashing_save(path, table, c, cursor, done):
        real_save(path, table, c, cursor, done)
        if not done:
            saves.append(cursor)
            raise Boom()

    with mock.patch.object(ckpt, "save_resume", crashing_save):
        with pytest.raises(Boom):
            build_sample_table_resumable(trio["child"], cfg, resume_path,
                                         save_every_flushes=1, device="cpu")
    assert len(saves) == 1
    _, cursor, done = ckpt.load_resume(resume_path, cfg, device="cpu")
    assert (cursor, done) == (saves[0], False)
    # the JAX package reads the port's resume checkpoint
    assert jax_ckpt.load_resume(resume_path, JaxConfig(**CFG))[1:] == (cursor, False)

    table = build_sample_table_resumable(trio["child"], cfg, resume_path,
                                         save_every_flushes=1, device="cpu")
    _same_table(table, golden)
    assert ckpt.load_resume(resume_path, cfg, device="cpu")[1:] == (-1, True)
    # already done: loads, still identical; and the JAX resumable build agrees
    _same_table(build_sample_table_resumable(trio["child"], cfg, resume_path, device="cpu"),
                golden)
    _same_table(table, jax_resumable(trio["child"], JaxConfig(**CFG),
                                     str(tmp_path / "jax.resume.npz"), save_every_flushes=1))


def test_run_trio_with_npz_parents_matches_jax(trio, jax_tables):
    cfg, jcfg = EngineConfig(**CFG), JaxConfig(**CFG)
    want = jax_run_trio(jax_tables["mom"], jax_tables["dad"], trio["child"], jcfg)
    events = io.StringIO()
    got = run_trio(jax_tables["mom"], jax_tables["dad"], trio["child"], cfg,
                   Metrics(json_stream=events), device="cpu")
    plain = run_trio(trio["mom"], trio["dad"], trio["child"], cfg, device="cpu")
    assert got.report == want.report == plain.report
    assert got.tables_n == want.tables_n == plain.tables_n
    assert got.candidates == want.candidates and len(got.candidates) > 0
    loaded = [e for e in map(json.loads, events.getvalue().splitlines())
              if e["event"] == "table_loaded"]
    assert [(e["sample"], e["path"]) for e in loaded] == [("mom", jax_tables["mom"]),
                                                          ("dad", jax_tables["dad"])]
    assert "build_mom" not in got.metrics.seconds


@pytest.mark.parametrize("k", [21, 32])
def test_run_trio_multipass_with_npz_parents_matches_jax(trio, tmp_path, k):
    """k=32 takes the compacting fallback; the parents' full tables are filtered by pass."""
    c = dict(CFG, k=k)
    cfg, jcfg = EngineConfig(**c), JaxConfig(**c)
    paths = {}
    for s in ("mom", "dad"):
        paths[s] = str(tmp_path / f"{s}.npz")
        jax_ckpt.save_table(paths[s], jax_build_sample_table(trio[s], jcfg), jcfg)
    want = jax_run_trio_multipass(paths["mom"], paths["dad"], trio["child"], jcfg, 3)
    got = run_trio_multipass(paths["mom"], paths["dad"], trio["child"], cfg, 3,
                             device="cpu")
    assert got.report == want.report
    assert got.tables_n == want.tables_n
    assert got.report == run_trio(trio["mom"], trio["dad"], trio["child"], cfg,
                                  device="cpu").report


def test_run_trio_spill_with_npz_parent_fails_as_jax_does(trio, jax_tables, tmp_path):
    """The spill decodes every sample, so a checkpoint parent is not a reads file there."""
    call = (jax_tables["mom"], trio["dad"], trio["child"])
    with pytest.raises(ValueError) as want:
        jax_run_trio_spill(*call, JaxConfig(**CFG), 2, device_store_rows=1 << 14)
    for kw in (dict(device_store_rows=1 << 14), dict(spill_dir=str(tmp_path / "sp"))):
        with pytest.raises(ValueError) as got:
            run_trio_spill(*call, EngineConfig(**CFG), 2, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_cli_count_writes_what_the_jax_cli_writes(trio, tmp_path, monkeypatch):
    """--ingest-threads is live: both CLIs set the feeder's thread count from it."""
    monkeypatch.setenv("DENOVO_KMER_INGEST_THREADS", "4")  # restored after the test
    for pkg, main, extra in (("jax", jax_cli.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        assert main(["count", trio["dad"], "-o", str(tmp_path / f"{pkg}.npz"),
                     "--ingest-threads", "2", *CLI_CFG, *extra]) == 0
        assert os.environ["DENOVO_KMER_INGEST_THREADS"] == "2"
        monkeypatch.setenv("DENOVO_KMER_INGEST_THREADS", "4")
    port, jax = _arrays(str(tmp_path / "port.npz")), _arrays(str(tmp_path / "jax.npz"))
    assert port[2] == jax[2] and port[2]["n"] > 0
    for a, b in zip(port[:2], jax[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cli_count_resume_equals_plain_count(trio, tmp_path):
    out = str(tmp_path / "child.npz")
    real_save = ckpt.save_resume
    calls = []

    def stop_after_first(path, table, c, cursor, done):
        real_save(path, table, c, cursor, done)
        calls.append(done)
        if not done:
            raise KeyboardInterrupt

    args = ["count", trio["child"], "-o", out, "--resume", "--ckpt-every", "1", *CLI_CFG,
            "--device", "cpu"]
    with mock.patch.object(ckpt, "save_resume", stop_after_first):
        with pytest.raises(KeyboardInterrupt):
            cli.main(args)
    assert calls == [False] and not os.path.exists(out)
    assert cli.main(args) == 0
    assert ckpt.load_resume(out + ".resume.npz", EngineConfig(**CFG),
                            device="cpu")[1:] == (-1, True)
    plain = str(tmp_path / "plain.npz")
    assert jax_cli.main(["count", trio["child"], "-o", plain, *CLI_CFG]) == 0
    got, want = _arrays(out), _arrays(plain)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("flags,match", [
    (["--passes", "2"], "only supported by `call`"),
    (["--spill-rows", "8"], "only supported by `call`"),
    (["--resume"], "needs a BAM input"),
])
def test_cli_count_rejects_what_the_jax_cli_rejects(tmp_path, flags, match):
    fq = tmp_path / "r.fastq"
    fq.write_text("@r\nACGTACGTACGTACGTACGTACGTA\n+\nIIIIIIIIIIIIIIIIIIIIIIIII\n")
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["count", str(fq), "-o", str(tmp_path / "x.npz"), *flags, *extra])
        assert match in str(e.value.code)


def _probe_stdout(main, argv, capsys, stdin=None):
    capsys.readouterr()
    if stdin is None:
        assert main(argv) == 0
    else:
        with mock.patch("sys.stdin", io.StringIO(stdin)):
            assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_probe_prints_what_the_jax_cli_prints(trio, jax_tables, capsys):
    from denovo_kmer_tpu_torch.io.bam import read_bam_records

    seqs = [r.seq for r in read_bam_records(trio["child"])][:40]
    kmers = [s[i:i + 21] for s in seqs for i in (0, 7)] + ["A" * 21, "acgtacgtacgtacgtacgta"]
    kmers = [q for q in kmers if "N" not in q.upper()]
    for how in ("flag", "stdin"):
        argv = ["probe", jax_tables["mom"], *CLI_CFG]
        stdin = None
        if how == "flag":
            argv += ["--kmers", ",".join(kmers)]
        else:
            stdin = "\n".join(kmers) + "\n"
        want = _probe_stdout(jax_cli.main, argv, capsys, stdin)
        got = _probe_stdout(cli.main, argv + ["--device", "cpu"], capsys, stdin)
        assert got == want
        counts = [int(line.split("\t")[1]) for line in got.splitlines()]
        assert len(counts) == len(kmers) and sum(c > 0 for c in counts) > len(kmers) // 2
