"""The port's multipass paths (denovo_kmer_tpu_torch/ops/spill.py, pipeline.run_trio_spill,
pipeline.run_trio_multipass, the CLI's --passes/--spill/--spill-rows) against the JAX
package on tests/test_spill.py's fixture: partition windows, the device store, host spill
files and manifests, and reports byte for byte. Tolerance 0: every quantity is an integer."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denovo_kmer_tpu import cli as jax_cli
from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.ops.spill import partition_window as jax_partition_window
from denovo_kmer_tpu.ops.spill import spill_capacity as jax_spill_capacity
from denovo_kmer_tpu.ops.stream import KmerAccumulator as JaxAccumulator
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu.pipeline import run_trio_multipass as jax_run_trio_multipass
from denovo_kmer_tpu.pipeline import run_trio_spill as jax_run_trio_spill
from denovo_kmer_tpu_torch import cli
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops import spill
from denovo_kmer_tpu_torch.ops.spill import (
    HostSpill,
    SpillOverflowError,
    alloc_pass_rows,
    empty_pass_store,
    partition_window,
    partition_window_blocks,
    source_signature,
    spill_capacity,
    store_append,
)
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator
from denovo_kmer_tpu_torch.pipeline import (
    TableOverflowError,
    run_trio,
    run_trio_multipass,
    run_trio_spill,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fixture and config of tests/test_spill.py
SPEC = dict(genome_len=3000, read_len=64, coverage=6.0, seed=55, n_inherited_snvs=5,
            n_denovo_snvs=3)
CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13, accum_batches=2)


@pytest.fixture(scope="module")
def trio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("spill_trio")
    write_trio_bams(make_trio(TrioSpec(**SPEC)), str(d))
    return str(d)


def _paths(d):
    return tuple(os.path.join(d, f"{s}.bam") for s in ("mom", "dad", "child"))


@pytest.fixture(scope="module")
def jax_runs(trio_dir, tmp_path_factory):
    """The JAX package's single-pass, device-spill, host-spill and multipass runs."""
    cfg = JaxConfig(**CFG)
    sd = str(tmp_path_factory.mktemp("jax_spill") / "spill")
    return {
        "golden": jax_run_trio(*_paths(trio_dir), cfg),
        "spill3": jax_run_trio_spill(*_paths(trio_dir), cfg, 3, device_store_rows=1 << 16),
        "host3": jax_run_trio_spill(*_paths(trio_dir), cfg, 3, spill_dir=sd),
        "host3_dir": sd,
        "multi3": jax_run_trio_multipass(*_paths(trio_dir), cfg, 3),
    }


# ---------------------------------------------------------------------------
# partition_window
# ---------------------------------------------------------------------------

def _window(S, W, fill, seed):
    rng = np.random.default_rng(seed)
    kmers = rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
    valid = rng.random(S) < 0.85
    return kmers, valid, fill


@pytest.mark.parametrize("S,W,fill,n_passes,factor", [
    (2048, 2, 2048, 3, 1.4),   # full window
    (2048, 1, 1500, 4, 1.4),   # partly filled
    (3000, 3, 3000, 2, 1.25),  # ragged last block
    (2048, 2, 2048, 4, 0.5),   # overflowing passes
])
def test_partition_window_matches_jax(S, W, fill, n_passes, factor, monkeypatch):
    kmers, valid, fill = _window(S, W, fill, seed=S + fill + n_passes)
    cap = spill_capacity(S, n_passes, factor)
    assert cap == jax_spill_capacity(S, n_passes, factor)
    jd, jc, jovf, _ = jax_partition_window(
        JaxAccumulator(kmers=jnp.asarray(kmers), valid=jnp.asarray(valid),
                       fill=jnp.asarray(fill, jnp.int32)), n_passes, cap)
    jd, jc = np.asarray(jd), np.asarray(jc)
    acc = KmerAccumulator(kmers=torch.from_numpy(kmers.view(np.int32)),
                          valid=torch.from_numpy(valid), fill=fill)
    # the CPU route (bucketize) and the card's route (per-block partition + assembly, here
    # with its plain partition over 256-row blocks so that several blocks are assembled)
    monkeypatch.setattr(spill, "SPILL_BLOCK_LANES", 256)
    disp, counts, ovf, reset = partition_window(acc, n_passes, cap)
    routes = [(disp, counts, ovf), partition_window_blocks(acc, n_passes, cap)]
    assert reset.fill == 0
    for d, c, o in routes:
        np.testing.assert_array_equal(c.numpy(), jc)
        assert int(o) == int(jovf)
        for p in range(n_passes):
            np.testing.assert_array_equal(d[p, :jc[p]].numpy().view(np.uint32),
                                          jd[p, :jc[p]])
    assert (int(jovf) > 0) == (factor < 1)


# ---------------------------------------------------------------------------
# the device store and the host spill
# ---------------------------------------------------------------------------

def test_store_append_never_clamps_near_full():
    """The port of tests/test_spill.py's test: a snugly sized store keeps every row."""
    rows_pp, cap, W = 8, 6, 1
    store = empty_pass_store(1, alloc_pass_rows(rows_pp, cap, 1), W, "cpu")
    d1 = torch.arange(cap, dtype=torch.int32).reshape(1, cap, W) + 1
    d2 = torch.arange(cap, dtype=torch.int32).reshape(1, cap, W) + 101
    store = store_append(store, d1, torch.tensor([3], dtype=torch.int32))
    store = store_append(store, d2, torch.tensor([3], dtype=torch.int32))
    assert store.rows[0, :6, 0].tolist() == [1, 2, 3, 101, 102, 103]
    assert store.fill == (6,)


def test_store_append_past_the_allocation_counts_every_row():
    """Rows that do not fit are not written, but fill counts them for the guard."""
    store = empty_pass_store(2, 4, 1, "cpu")
    d = torch.arange(12, dtype=torch.int32).reshape(2, 6, 1) + 1
    store = store_append(store, d, [3, 1])
    store = store_append(store, d, [3, 2])
    assert store.fill == (6, 3)
    assert store.rows[0, :, 0].tolist() == [1, 2, 3, 1]
    assert store.rows[1, :3, 0].tolist() == [7, 7, 8]


def test_host_spill_round_trip_resume_and_rejection(trio_dir, tmp_path):
    cfg = EngineConfig(**CFG)
    path = _paths(trio_dir)[0]
    sig = source_signature(path, cfg)
    d = torch.arange(2 * 5 * 2, dtype=torch.int32).reshape(2, 5, 2) - 7  # negative = high bits
    hs = HostSpill(str(tmp_path), "mom", 2, 2, cfg.config_hash(), sig)
    assert not hs.complete()
    hs.open_for_write()
    hs.append_window(d, torch.tensor([3, 0]))
    hs.append_window(d, torch.tensor([1, 5]))
    hs.finish()
    again = HostSpill(str(tmp_path), "mom", 2, 2, cfg.config_hash(), sig)
    assert again.complete() and again.counts == [4, 5]
    chunks = list(again.read_chunks(0, 3))
    assert [t for _, t in chunks] == [3, 1]
    rows = np.concatenate([b[:t] for b, t in chunks]).view(np.int32)
    np.testing.assert_array_equal(rows, np.concatenate([d[0, :3], d[0, :1]]))
    assert [t for _, t in again.read_chunks(1, 8)] == [5]
    # another source, another config or another pass count is not this spill
    other = dict(sig, size=sig["size"] + 1)
    assert not HostSpill(str(tmp_path), "mom", 2, 2, cfg.config_hash(), other).complete()
    assert not HostSpill(str(tmp_path), "mom", 2, 2, "0" * 16, sig).complete()
    assert not HostSpill(str(tmp_path), "mom", 3, 2, cfg.config_hash(), sig).complete()
    # a truncated manifest reads as incomplete, never as an error
    with open(again.manifest_path(), "w") as f:
        f.write('{"config_hash": "abc", "n_pas')
    assert not HostSpill(str(tmp_path), "mom", 2, 2, cfg.config_hash(), sig).complete()


def test_source_signature_matches_jax(trio_dir):
    from denovo_kmer_tpu.ops.spill import source_signature as jax_source_signature

    path = _paths(trio_dir)[2]
    assert source_signature(path, EngineConfig(**CFG), "chr1:1-100") == \
        jax_source_signature(path, JaxConfig(**CFG), "chr1:1-100")


# ---------------------------------------------------------------------------
# run_trio_spill and run_trio_multipass against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_passes", [2, 3, 4])
def test_device_spill_matches_jax(trio_dir, jax_runs, n_passes):
    res = run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), n_passes,
                         device_store_rows=1 << 16, device="cpu")
    assert res.report == jax_runs["golden"].report
    assert res.candidates == jax_runs["golden"].candidates
    assert res.tables_n == jax_runs["spill3"].tables_n
    assert res.candidates


def test_host_spill_matches_jax_and_resumes(trio_dir, jax_runs, tmp_path):
    cfg = EngineConfig(**CFG)
    sd = str(tmp_path / "spill")
    res = run_trio_spill(*_paths(trio_dir), cfg, 3, spill_dir=sd, device="cpu")
    assert res.report == jax_runs["host3"].report == jax_runs["golden"].report
    assert res.tables_n == jax_runs["host3"].tables_n
    # the spill files and manifests are the JAX package's, byte for byte
    names = sorted(os.listdir(sd))
    assert names == sorted(os.listdir(jax_runs["host3_dir"]))
    for f in names:
        with open(os.path.join(sd, f), "rb") as a, \
                open(os.path.join(jax_runs["host3_dir"], f), "rb") as b:
            assert a.read() == b.read(), f
    # resume: nothing is decoded again and no spill file is touched
    stats = {f: os.stat(os.path.join(sd, f)) for f in names}
    res2 = run_trio_spill(*_paths(trio_dir), cfg, 3, spill_dir=sd, device="cpu")
    assert res2.report == res.report
    assert res2.metrics.counters.get("reads_ingested", 0) == 0
    for f, st in stats.items():
        st2 = os.stat(os.path.join(sd, f))
        assert (st.st_mtime_ns, st.st_size) == (st2.st_mtime_ns, st2.st_size), f


def test_host_spill_redecodes_an_incomplete_sample(trio_dir, jax_runs, tmp_path):
    cfg = EngineConfig(**CFG)
    sd = str(tmp_path / "spill")
    run_trio_spill(*_paths(trio_dir), cfg, 2, spill_dir=sd, device="cpu")
    os.remove(os.path.join(sd, "dad.manifest.json"))
    with open(os.path.join(sd, "dad.pass0.u32"), "r+b") as f:
        f.truncate(64)  # a partial write
    res = run_trio_spill(*_paths(trio_dir), cfg, 2, spill_dir=sd, device="cpu")
    assert res.report == jax_runs["golden"].report
    assert res.metrics.counters["reads_ingested"] > 0


def test_multipass_matches_jax(trio_dir, jax_runs):
    res = run_trio_multipass(*_paths(trio_dir), EngineConfig(**CFG), 3, device="cpu")
    assert res.report == jax_runs["multi3"].report == jax_runs["golden"].report
    assert res.tables_n == jax_runs["multi3"].tables_n
    assert res.candidates == jax_runs["golden"].candidates


def test_multipass_k32_takes_the_score_fallback(trio_dir):
    """2k % 32 == 0 has no fused call: each pass scores and calls from its ScoreTable."""
    cfg = dict(CFG, k=32)
    want = run_trio(*_paths(trio_dir), EngineConfig(**cfg), device="cpu")
    got = run_trio_multipass(*_paths(trio_dir), EngineConfig(**cfg), 2, device="cpu")
    assert got.report == want.report and got.tables_n == want.tables_n
    assert got.candidates


def test_capacity_smaller_than_single_pass(trio_dir, jax_runs):
    """A table capacity that overflows one pass suffices spilled into four passes."""
    small = EngineConfig(**dict(CFG, table_capacity=1 << 11))
    with pytest.raises(TableOverflowError):
        run_trio(*_paths(trio_dir), small, device="cpu")
    res = run_trio_spill(*_paths(trio_dir), small, 4, device_store_rows=1 << 16, device="cpu")
    assert res.report == jax_runs["golden"].report
    res = run_trio_multipass(*_paths(trio_dir), small, 4, device="cpu")
    assert res.report == jax_runs["golden"].report


def test_partition_overflow_is_loud(trio_dir):
    with pytest.raises(SpillOverflowError, match="capacity_factor"):
        run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), 4, device_store_rows=1 << 16,
                       capacity_factor=0.1, device="cpu")


def test_undersized_store_is_loud(trio_dir):
    with pytest.raises(SpillOverflowError, match="device_store_rows"):
        run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), 2, device_store_rows=256,
                       device="cpu")


def test_spill_needs_exactly_one_sink(trio_dir, tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), 2, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), 2, spill_dir=str(tmp_path),
                       device_store_rows=64, device="cpu")


@pytest.mark.parametrize("what", ["npz", "buckets"])
@pytest.mark.parametrize("entry", ["spill", "multipass"])
def test_unported_inputs_name_the_roadmap(trio_dir, jax_runs, tmp_path, what, entry):
    """Checkpoint parents and length buckets, once refused here, now run in both entries as
    the JAX package runs them: bucketed, each gives run_trio's report; a `count` checkpoint
    parent feeds the re-decode multipass, and fails in the spill (which decodes every
    sample) with the JAX package's own error."""
    from denovo_kmer_tpu.utils.checkpoint import save_table as jax_save_table
    from denovo_kmer_tpu.pipeline import build_sample_table as jax_build_sample_table

    mom, dad, child = _paths(trio_dir)
    cfg = EngineConfig(**CFG)
    if what == "npz":
        npz = str(tmp_path / "mom.npz")
        jax_save_table(npz, jax_build_sample_table(mom, JaxConfig(**CFG)), JaxConfig(**CFG))
        mom = npz
    else:
        cfg = EngineConfig(**dict(CFG, read_len_buckets=(32, 64)))
    if entry == "multipass":
        res = run_trio_multipass(mom, dad, child, cfg, 2, device="cpu")
        assert res.report == jax_runs["golden"].report
    elif what == "buckets":
        res = run_trio_spill(mom, dad, child, cfg, 2, device_store_rows=1 << 16, device="cpu")
        assert res.report == jax_runs["golden"].report
    else:
        with pytest.raises(ValueError) as want:
            jax_run_trio_spill(mom, dad, child, JaxConfig(**CFG), 2, device_store_rows=64)
        with pytest.raises(ValueError) as got:
            run_trio_spill(mom, dad, child, cfg, 2, device_store_rows=64, device="cpu")
        assert str(got.value) == str(want.value)


def test_cuda_request_without_a_card_raises(trio_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the request is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), 2, device_store_rows=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_trio_multipass(*_paths(trio_dir), EngineConfig(**CFG), 2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _call_args(trio_dir, out, *extra):
    mom, dad, child = _paths(trio_dir)
    return ["call", "--mom", mom, "--dad", dad, "--child", child, "-k", "21",
            "--max-read-len", "64", "--batch-reads", "64", "--table-capacity", str(1 << 13),
            "--accum-batches", "2", "-o", str(out), *extra]


@pytest.fixture(scope="module")
def jax_cli_tsv(trio_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_cli") / "jax.tsv"
    assert jax_cli.main(_call_args(trio_dir, out, "--passes", "3", "--spill-rows",
                                   "65536")) == 0
    return out.read_text()


@pytest.mark.parametrize("mode", [["--spill-rows", "65536"], ["--spill", "DIR"], []])
def test_cli_multipass_matches_jax_cli(trio_dir, jax_cli_tsv, tmp_path, mode):
    mode = [str(tmp_path / "spill") if a == "DIR" else a for a in mode]
    out = tmp_path / "port.tsv"
    assert cli.main(_call_args(trio_dir, out, "--passes", "3", *mode, "--device", "cpu")) == 0
    assert out.read_text() == jax_cli_tsv
    assert jax_cli_tsv.count("\n") > 1


def test_cli_module_entry_runs_the_spill(trio_dir, jax_cli_tsv, tmp_path):
    out = tmp_path / "port.tsv"
    r = subprocess.run([sys.executable, "-m", "denovo_kmer_tpu_torch",
                        *_call_args(trio_dir, out, "--passes", "3", "--spill-rows", "65536",
                                    "--device", "cpu")],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == jax_cli_tsv


@pytest.mark.parametrize("flags,match", [
    (["--spill", "DIR"], "require --passes"),
    (["--spill-rows", "64"], "require --passes"),
    (["--passes", "2", "--spill", "DIR", "--spill-rows", "64"], "exclusive"),
    (["--passes", "2", "--spill-rows", "0"], "must be >= 1"),
    (["--passes", "2", "--spill", "DIR", "--mesh", "2x1"], "single-chip host spill"),
    (["--passes", "2", "--spill-rows", "0", "--mesh", "2x1"], "must be >= 1"),
])
def test_cli_rejects_bad_multipass_flags(trio_dir, tmp_path, flags, match):
    flags = [str(tmp_path / "spill") if a == "DIR" else a for a in flags]
    with pytest.raises(SystemExit, match=match):
        cli.main(_call_args(trio_dir, tmp_path / "x.tsv", *flags, "--device", "cpu"))
    assert not (tmp_path / "spill").exists()


def test_card_spill_pass_limit_raises_before_decoding(trio_dir, monkeypatch):
    """On the card the partition kernel holds n_passes + 1 <= 1024 buckets; the spill
    says so before it decodes anything (ROADMAP.md §3)."""
    import denovo_kmer_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(pipeline, "_spill_stream", None)  # a decode would fail differently
    with pytest.raises(ValueError, match="at most 1023"):
        run_trio_spill(*_paths(trio_dir), EngineConfig(**CFG), 1024, device_store_rows=64)
