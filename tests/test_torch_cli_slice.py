"""The port's `sweep`, `cohort`, `evidence` and `sites` subcommands and `call
--evidence-out/--sites-out` (denovo_kmer_tpu_torch/cli.py) against the JAX CLI on the CPU,
on the fixture of tests/test_cli.py and on CRAM inputs (`--reference`) and region-restricted
BAM/CRAM inputs (`--region`, `--regions-bed`): every output file byte-equal to the one the
JAX CLI writes (the parental superset `.npz`: its arrays and meta equal); `call
--profile-dir` writes a trace. Tolerance: byte-equal."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from denovo_kmer_tpu import cli as jax_cli
from denovo_kmer_tpu_torch import cli

torch.set_num_threads(1)

ENGINE_ARGS = ["-k", "21", "--max-read-len", "64", "--batch-reads", "64",
               "--table-capacity", str(1 << 13)]
PKGS = {"jax": (jax_cli.main, []), "port": (cli.main, ["--device", "cpu"])}


@pytest.fixture(scope="module")
def trio_dir(tmp_path_factory):
    """tests/test_cli.py's trio, and a second one from another seed."""
    d = tmp_path_factory.mktemp("cli_slice")
    assert cli.main(["synth-trio", str(d), "--genome-len", "1500", "--coverage", "6",
                     "--read-len", "50", "--denovo", "3"]) == 0
    assert cli.main(["synth-trio", str(d / "b"), "--genome-len", "1500", "--coverage", "6",
                     "--read-len", "50", "--denovo", "3", "--seed", "9"]) == 0
    return d


def _trio_args(d):
    return ["--mom", str(d / "mom.bam"), "--dad", str(d / "dad.bam"),
            "--child", str(d / "child.bam")]


def _run_both(tmp_path, argv_of, capsys=None):
    """Run ``argv_of(out_dir)`` through both CLIs, each into its own directory; → the two
    directories (and the two stdouts when ``capsys`` is given)."""
    dirs, stdout = {}, {}
    for pkg, (main, extra) in PKGS.items():
        dirs[pkg] = tmp_path / pkg
        dirs[pkg].mkdir()
        assert main([*argv_of(dirs[pkg]), *ENGINE_ARGS, *extra]) == 0
        if capsys is not None:
            stdout[pkg] = capsys.readouterr().out
    return (dirs, stdout) if capsys is not None else dirs


def _same_files(dirs, names):
    for name in names:
        port, jax = dirs["port"] / name, dirs["jax"] / name
        assert port.read_bytes() == jax.read_bytes(), name


def test_sweep_cli_matches_jax(trio_dir, tmp_path):
    dirs = _run_both(tmp_path, lambda o: ["sweep", *_trio_args(trio_dir), "--ks", "15,21,32",
                                          "-o", str(o / "c.k{k}.tsv")])
    _same_files(dirs, ["c.k15.tsv", "c.k21.tsv", "c.k32.tsv"])
    assert (dirs["port"] / "c.k21.tsv").read_text().count("\n") > 1


def test_sweep_cli_rejects_a_pattern_without_k(trio_dir, tmp_path):
    for main, extra in PKGS.values():
        with pytest.raises(SystemExit, match="output-pattern"):
            main(["sweep", *_trio_args(trio_dir), "--ks", "15", "-o",
                  str(tmp_path / "flat.tsv"), *ENGINE_ARGS, *extra])


def _npz(path):
    with np.load(path) as z:
        return z["keys"], z["counts"], json.loads(bytes(z["meta"]).decode())


@pytest.mark.parametrize("superset", [True, False])
def test_cohort_cli_manifest_matches_jax(trio_dir, tmp_path, superset):
    man = tmp_path / "man.tsv"
    b = trio_dir / "b"
    man.write_text("# two trios\n"
                   f"t1\t{trio_dir/'mom.bam'}\t{trio_dir/'dad.bam'}\t{trio_dir/'child.bam'}\n"
                   f"t2\t{b/'mom.bam'}\t{b/'dad.bam'}\t{b/'child.bam'}\n")
    flags = [] if superset else ["--no-superset"]
    dirs = _run_both(tmp_path, lambda o: ["cohort", str(man), "-o", str(o / "coh"), *flags])
    _same_files({k: v / "coh" for k, v in dirs.items()},
                ["t1.candidates.tsv", "t2.candidates.tsv"])
    sup = {k: v / "coh" / "parental_superset.npz" for k, v in dirs.items()}
    assert sup["port"].exists() == sup["jax"].exists() == superset
    if superset:
        got, want = _npz(sup["port"]), _npz(sup["jax"])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and got[2]["source"] == str(man)


def test_cohort_cli_ped_matches_jax(trio_dir, tmp_path):
    """--ped resolved through --bam-dir and through --sample-map: the same trio, the same
    report as the JAX CLI's."""
    d = tmp_path / "samples"
    d.mkdir()
    for src, iid in (("mom", "M1"), ("dad", "F1"), ("child", "C1")):
        shutil.copy(trio_dir / f"{src}.bam", d / f"{iid}.bam")
    ped = tmp_path / "fam.ped"
    ped.write_text("# family pedigree\nFAM1 F1 0 0 1 1\nFAM1 M1 0 0 2 1\nFAM1 C1 F1 M1 1 2\n")
    smap = tmp_path / "map.tsv"
    smap.write_text(f"F1\t{d/'F1.bam'}\nM1\t{d/'M1.bam'}\nC1\t{d/'C1.bam'}\n")
    for how in (["--bam-dir", str(d)], ["--sample-map", str(smap)]):
        out = tmp_path / how[0].strip("-")
        out.mkdir()
        dirs = _run_both(out, lambda o: ["cohort", "--ped", str(ped), *how, "-o", str(o),
                                         "--no-superset"])
        _same_files(dirs, ["FAM1_C1.candidates.tsv"])
    with pytest.raises(SystemExit, match="exactly one"):
        cli.main(["cohort", "-o", str(tmp_path / "x"), *ENGINE_ARGS, "--device", "cpu"])
    bad = tmp_path / "bad.tsv"
    bad.write_text("F1\tnope.bam\n")
    with pytest.raises(SystemExit, match="no entry"):
        cli.main(["cohort", "--ped", str(ped), "--sample-map", str(bad), "-o",
                  str(tmp_path / "y"), *ENGINE_ARGS, "--device", "cpu"])


@pytest.fixture(scope="module")
def candidates_tsv(trio_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("cands") / "c.tsv"
    assert cli.main(["call", *_trio_args(trio_dir), "-o", str(out), *ENGINE_ARGS,
                     "--device", "cpu"]) == 0
    assert out.read_text().count("\n") > 1
    return out


@pytest.mark.parametrize("ext", ["bam", "sam", "fastq"])
def test_evidence_cli_matches_jax(trio_dir, candidates_tsv, tmp_path, ext):
    dirs = _run_both(tmp_path, lambda o: [
        "evidence", "--child", str(trio_dir / "child.bam"), "--candidates",
        str(candidates_tsv), "-o", str(o / f"ev.{ext}"), "--per-candidate", str(o / "pc.tsv")])
    _same_files(dirs, [f"ev.{ext}", "pc.tsv"])


def test_sites_cli_matches_jax(trio_dir, candidates_tsv, tmp_path):
    dirs = _run_both(tmp_path, lambda o: ["sites", str(trio_dir / "child.bam"),
                                          str(candidates_tsv), "-o", str(o / "s.tsv")])
    _same_files(dirs, ["s.tsv"])
    assert (dirs["port"] / "s.tsv").read_text().count("\n") > 1


@pytest.mark.parametrize("output", ["file", "stdout", "fasta"])
def test_call_evidence_and_sites_out_match_jax(trio_dir, tmp_path, capsys, output):
    """call --evidence-out/--sites-out: with a TSV file, with the report on stdout, and with
    FASTA output (the last two stage the TSV in a temporary file)."""
    def argv(o):
        out = ["-o", "-"] if output == "stdout" else ["-o", str(o / "c.out")]
        fmt = ["--output-format", "fasta"] if output == "fasta" else []
        return ["call", *_trio_args(trio_dir), *out, *fmt, "--evidence-out",
                str(o / "ev.bam"), "--sites-out", str(o / "s.tsv")]

    dirs, stdout = _run_both(tmp_path, argv, capsys)
    _same_files(dirs, ["ev.bam", "s.tsv"] + ([] if output == "stdout" else ["c.out"]))
    assert stdout["port"] == stdout["jax"]
    ev = dirs["port"] / "ev.bam"
    assert ev.stat().st_size > 28  # more than an empty BGZF stream
    # no temporary TSV is left behind
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))


@pytest.mark.parametrize("argv", [
    ["sweep", "--ks", "15,21"], ["cohort", "man.tsv", "-o", "coh"],
    ["evidence", "--child", "c.bam", "--candidates", "c.tsv", "-o", "ev.bam"],
    ["sites", "c.bam", "c.tsv", "-o", "s.tsv"],
])
def test_slice_commands_reject_unported_flags(trio_dir, argv):
    """--mesh (the sharded twins) exits non-zero, naming ROADMAP.md, also beside a live
    --region."""
    if argv[0] == "sweep":
        argv = [*argv, *_trio_args(trio_dir)]
    for flag in (["--mesh", "2x2"], ["--mesh", "1x2", "--region", "chr20"]):
        with pytest.raises(SystemExit) as e:
            cli.main([*argv, *ENGINE_ARGS, "--device", "cpu", *flag])
        assert "not yet ported (ROADMAP.md)" in str(e.value.code)


def test_sweep_and_cohort_reject_passes(trio_dir, tmp_path):
    """--passes and the spill flags belong to `call`, as in the JAX CLI."""
    man = tmp_path / "man.tsv"
    man.write_text(f"t1\t{trio_dir/'mom.bam'}\t{trio_dir/'dad.bam'}\t{trio_dir/'child.bam'}\n")
    for argv in (["sweep", *_trio_args(trio_dir), "-o", str(tmp_path / "c{k}.tsv")],
                 ["cohort", str(man), "-o", str(tmp_path / "coh")]):
        with pytest.raises(SystemExit, match="only supported by `call`"):
            cli.main([*argv, "--passes", "2", *ENGINE_ARGS, "--device", "cpu"])


# ---- the inputs of the seventh slice: CRAM (--reference), --region, --regions-bed ----

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from _torch_inputs import write_inputs

    return write_inputs(tmp_path_factory.mktemp("cli_inputs"))


def _input_args(inputs, how, tmp_path):
    """The reads flags of one input case: CRAM with --reference, CRAM or BAM with
    --region, BAM with --regions-bed."""
    fmt = "bam" if how.startswith("bam") else "cram"
    extra = ["--reference", inputs["reference"]]
    if how.endswith("_region"):
        extra += ["--region", "chr20:600-2200"]
    elif how.endswith("_bed"):
        bed = tmp_path / "r.bed"
        bed.write_text("chr20\t100\t900\nchr20\t1500\t2300\n")
        extra += ["--regions-bed", str(bed)]
    return {s: inputs[s][fmt] for s in ("mom", "dad", "child")}, extra


CASES = ["cram", "cram_region", "bam_region", "bam_bed"]


@pytest.mark.parametrize("how", CASES)
def test_call_with_evidence_and_sites_on_new_inputs_matches_jax(inputs, tmp_path, how):
    paths, extra = _input_args(inputs, how, tmp_path)
    dirs = _run_both(tmp_path, lambda o: [
        "call", "--mom", paths["mom"], "--dad", paths["dad"], "--child", paths["child"],
        "-o", str(o / "c.tsv"), "--evidence-out", str(o / "ev.bam"), "--sites-out",
        str(o / "s.tsv"), *extra])
    _same_files(dirs, ["c.tsv", "ev.bam", "s.tsv"])
    assert (dirs["port"] / "c.tsv").read_text().count("\n") > 1


@pytest.mark.parametrize("how", ["cram", "bam_region"])
def test_sweep_on_new_inputs_matches_jax(inputs, tmp_path, how):
    paths, extra = _input_args(inputs, how, tmp_path)
    dirs = _run_both(tmp_path, lambda o: [
        "sweep", "--mom", paths["mom"], "--dad", paths["dad"], "--child", paths["child"],
        "--ks", "15,21", "-o", str(o / "c.k{k}.tsv"), *extra])
    _same_files(dirs, ["c.k15.tsv", "c.k21.tsv"])


@pytest.mark.parametrize("how", ["cram", "cram_region"])
def test_cohort_on_new_inputs_matches_jax(inputs, tmp_path, how):
    paths, extra = _input_args(inputs, how, tmp_path)
    man = tmp_path / "man.tsv"
    man.write_text(f"t1\t{paths['mom']}\t{paths['dad']}\t{paths['child']}\n"
                   f"t2\t{inputs['dad']['bam']}\t{paths['mom']}\t{paths['child']}\n")
    dirs = _run_both(tmp_path, lambda o: ["cohort", str(man), "-o", str(o), *extra])
    _same_files(dirs, ["t1.candidates.tsv", "t2.candidates.tsv"])
    got, want = (_npz(dirs[p] / "parental_superset.npz") for p in ("port", "jax"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("how", ["cram", "cram_region", "bam_bed"])
def test_evidence_and_sites_on_new_inputs_match_jax(inputs, candidates_tsv, tmp_path, how):
    paths, extra = _input_args(inputs, how, tmp_path)
    dirs = _run_both(tmp_path, lambda o: [
        "evidence", "--child", paths["child"], "--candidates", str(candidates_tsv), "-o",
        str(o / "ev.sam"), "--per-candidate", str(o / "pc.tsv"), *extra])
    _same_files(dirs, ["ev.sam", "pc.tsv"])
    (tmp_path / "sites").mkdir()
    dirs = _run_both(tmp_path / "sites", lambda o: [
        "sites", paths["child"], str(candidates_tsv), "-o", str(o / "s.tsv"), *extra])
    _same_files(dirs, ["s.tsv"])


def test_call_profile_dir_writes_a_trace(inputs, tmp_path):
    """call --profile-dir: a torch.profiler Chrome trace of the run (CPU activity here)
    lands in the directory; the report is the one written without it."""
    paths, extra = _input_args(inputs, "cram", tmp_path)
    trio = ["--mom", paths["mom"], "--dad", paths["dad"], "--child", paths["child"]]
    prof = tmp_path / "prof"
    for out, flags in (("a.tsv", ["--profile-dir", str(prof)]), ("b.tsv", [])):
        assert cli.main(["call", *trio, "-o", str(tmp_path / out), *ENGINE_ARGS, *extra,
                         "--device", "cpu", *flags]) == 0
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert trace["traceEvents"]
    assert (tmp_path / "a.tsv").read_text() == (tmp_path / "b.tsv").read_text()
