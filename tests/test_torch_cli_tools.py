"""The port's table and host subcommands (denovo_kmer_tpu_torch/cli.py: merge, histo, dump,
stats, view, flagstat, idxstats, depth, bedcov, index, sort, faidx, bgzip, doctor) against the
JAX CLI on tests/test_cli.py's inputs: each argv runs through ``denovo_kmer_tpu.cli.main``
and then, with the same output paths, through the port's ``main`` (``--device cpu`` where the
subcommand takes the engine flags); return codes, stdout and every output file are
byte-equal. ``doctor`` is checked for its lines and its ``--probe-feed`` verdicts."""

import gzip
import os

import numpy as np
import pytest

from denovo_kmer_tpu.cli import main as jax_main
from denovo_kmer_tpu_torch.cli import main as port_main

ENGINE_ARGS = ["-k", "21", "--max-read-len", "64", "--batch-reads", "64",
               "--table-capacity", str(1 << 13)]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def trio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_tools")
    assert jax_main(["synth-trio", str(d), "--genome-len", "1500", "--coverage", "6",
                     "--read-len", "50", "--denovo", "3"]) == 0
    for name in ("mom", "dad", "child"):
        assert jax_main(["count", str(d / f"{name}.bam"), "-o", str(d / f"{name}.npz"),
                         *ENGINE_ARGS]) == 0
    return d


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def both(capsys, argv, outputs=(), port_extra=(), rc=0):
    """Run ``argv`` through the JAX CLI, set its output files aside, run it through the
    port's; assert equal return codes, stdout and output bytes. Returns the stdout."""
    results = []
    for main, extra in ((jax_main, ()), (port_main, tuple(port_extra))):
        for p in outputs:
            if os.path.exists(p):
                os.remove(p)
        got = main([*argv, *extra])
        out = capsys.readouterr().out
        results.append((got, out, {p: _read(p) for p in outputs}))
    assert results[0][0] == results[1][0] == rc
    assert results[1][1] == results[0][1]
    for p in outputs:
        assert results[1][2][p] == results[0][2][p], p
    return results[1][1]


def both_exit(capsys, argv, port_extra=()):
    """Both CLIs refuse ``argv`` with the same SystemExit."""
    msgs = []
    for main, extra in ((jax_main, ()), (port_main, tuple(port_extra))):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        capsys.readouterr()
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("extra", [[], ["--low", "2", "--high", "3"]])
def test_histo(trio_dir, capsys, extra):
    out = both(capsys, ["histo", str(trio_dir / "child.npz"), *extra, *ENGINE_ARGS],
               port_extra=CPU)
    assert out.strip()


@pytest.mark.parametrize("fasta", [False, True])
def test_dump(trio_dir, tmp_path, capsys, fasta):
    out = str(tmp_path / ("d.fa" if fasta else "d.tsv"))
    flags = ["--fasta"] if fasta else []
    both(capsys, ["dump", str(trio_dir / "mom.npz"), "-o", out, *flags, *ENGINE_ARGS],
         [out], port_extra=CPU)
    both(capsys, ["dump", str(trio_dir / "dad.npz"), *flags, *ENGINE_ARGS], port_extra=CPU)


def test_stats(trio_dir, capsys):
    for name in ("mom", "child"):
        out = both(capsys, ["stats", str(trio_dir / f"{name}.npz"), *ENGINE_ARGS],
                   port_extra=CPU)
        assert out.startswith("Unique:")


def test_merge(trio_dir, tmp_path, capsys):
    out = str(tmp_path / "parents.npz")
    both(capsys, ["merge", str(trio_dir / "mom.npz"), str(trio_dir / "dad.npz"),
                  str(trio_dir / "child.npz"), "-o", out, *ENGINE_ARGS], [out],
         port_extra=CPU)
    # an overflowing merge raises the same error in both
    small = [*ENGINE_ARGS[:-1], str(1 << 10)]
    msgs = []
    for main, extra in ((jax_main, ()), (port_main, CPU)):
        with pytest.raises(Exception) as e:
            main(["merge", str(trio_dir / "mom.npz"), str(trio_dir / "dad.npz"), "-o",
                  out, *small, *extra])
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("fmt,name", [("sam", "-"), ("sam", "v.sam"), ("bam", "v.bam"),
                                      ("fastq", "v.fastq"), ("fasta", "v.fa")])
def test_view_formats(trio_dir, tmp_path, capsys, fmt, name):
    bam = str(trio_dir / "child.bam")
    out = name if name == "-" else str(tmp_path / name)
    outputs = [] if out == "-" else [out]
    both(capsys, ["view", bam, "-o", out], outputs)
    both(capsys, ["view", bam, "-o", out, "--format", fmt, "-F", "0x10", "-s", "3.5"],
         outputs)
    if fmt == "sam":
        both(capsys, ["view", bam, "-o", out, "--no-header"], outputs)


def test_view_count_subsample_and_sam_input(trio_dir, tmp_path, capsys):
    bam = str(trio_dir / "child.bam")
    for flags in ([], ["-F", "0x400"], ["-s", "7.25"], ["-s", "8.25", "-F", "0x10"]):
        both(capsys, ["view", "-c", *flags, bam])
    both_exit(capsys, ["view", "-c", "-s", "7", bam])
    sam = str(tmp_path / "v.sam")
    assert jax_main(["view", bam, "-o", sam]) == 0
    back = str(tmp_path / "back.bam")
    both(capsys, ["view", sam, "-o", back], [back])
    both_exit(capsys, ["view", bam, "--format", "bam"])


def test_view_region_sort_and_index(trio_dir, tmp_path, capsys):
    bam = str(trio_dir / "child.bam")
    s = str(tmp_path / "s.bam")
    both(capsys, ["sort", bam, "-o", s], [s])
    both(capsys, ["index", s], [s + ".bai"])
    both(capsys, ["index", s, "--csi"], [s + ".csi"])
    for region in ("chr20:500-1500", "chr20"):
        both(capsys, ["view", "-c", s, "--region", region])
        out = str(tmp_path / "r.sam")
        both(capsys, ["view", s, "--region", region, "-o", out], [out])
    bed = tmp_path / "r.bed"
    bed.write_text("chr20\t100\t400\nchr20\t900\t1200\n")
    both(capsys, ["view", "-c", s, "--regions-bed", str(bed)])


@pytest.mark.parametrize("ver", ["3.0", "3.1"])
def test_view_cram_output(trio_dir, tmp_path, capsys, monkeypatch, ver):
    bam, ref = str(trio_dir / "child.bam"), str(trio_dir / "ref.fa")
    out = str(tmp_path / f"c{ver}.cram")
    both(capsys, ["view", bam, "-o", out, "--reference", ref, "--cram-version", ver], [out])
    # a .crai is gzip, whose header holds the write time in seconds: both writers get one
    # time, so two runs a second apart still give the same bytes
    monkeypatch.setattr(gzip.time, "time", lambda: 1_700_000_000.0)
    both(capsys, ["index", out], [out + ".crai"])
    monkeypatch.undo()
    both(capsys, ["view", bam, "-o", out, "--cram-version", ver], [out])  # no reference
    both(capsys, ["flagstat", out])
    both_exit(capsys, ["index", out, "--csi"])


def test_flagstat(trio_dir, tmp_path, capsys):
    bam = str(trio_dir / "child.bam")
    out = both(capsys, ["flagstat", bam])
    assert "\ttotal\n" in out
    s = str(tmp_path / "s.bam")
    assert jax_main(["sort", bam, "-o", s]) == 0 and jax_main(["index", s]) == 0
    capsys.readouterr()
    both(capsys, ["flagstat", s, "--region", "chr20:200-900"])


def test_idxstats_by_stream_and_by_index(trio_dir, tmp_path, capsys):
    bam = str(trio_dir / "child.bam")
    s = str(tmp_path / "c.sorted.bam")
    assert jax_main(["sort", bam, "-o", s]) == 0
    sam = str(tmp_path / "c.sam")
    assert jax_main(["view", bam, "-o", sam]) == 0
    capsys.readouterr()
    streamed = both(capsys, ["idxstats", s])  # no index: the record stream
    assert jax_main(["index", s]) == 0
    capsys.readouterr()
    assert both(capsys, ["idxstats", s]) == streamed  # the .bai's pseudo-bins
    assert both(capsys, ["idxstats", sam]) == streamed


def _depth_bam(tmp_path):
    from denovo_kmer_tpu.io.bam import BamRecord, BamWriter

    L = 400
    refs = [("c1", L), ("c2", L)]

    def mk(i, refid, pos, cigar, flag=0):
        n = sum(n for n, op in cigar if op in (0, 1, 4, 7, 8))
        return BamRecord(name=f"r{i}", flag=flag, refid=refid, pos=pos, mapq=60,
                         cigar=cigar, seq="A" * n, qual=(30,) * n)

    recs = [
        mk(0, 0, 10, ((20, 0),)),
        mk(1, 0, 15, ((5, 4), (10, 0), (6, 2), (10, 0))),
        mk(2, 0, 25, ((8, 0), (4, 1), (8, 7), (100, 3), (8, 8))),
        mk(3, 1, 0, ((30, 0),)),
        mk(4, 0, 50, ((20, 0),), flag=0x400),
        mk(5, 0, 60, ((20, 0),), flag=0x100),
        mk(6, 0, 70, ((20, 0),), flag=0x4),
    ] + [mk(10 + i, 0, 10 * i, ((40, 0),)) for i in range(9)]
    bam = str(tmp_path / "d.bam")
    with open(bam, "wb") as f, BamWriter(f, references=refs) as w:
        for r in sorted(recs, key=lambda r: (r.refid, r.pos)):
            w.write(r)
    return bam


def test_depth_and_bedcov(tmp_path, capsys):
    bam = _depth_bam(tmp_path)
    assert jax_main(["index", bam]) == 0
    capsys.readouterr()
    out = str(tmp_path / "depth.tsv")
    for flags in ([], ["-a"], ["-F", "0"], ["--region", "c1:20-40", "-a"],
                  ["--region", "c2:5-300"]):
        both(capsys, ["depth", bam, *flags])
        both(capsys, ["depth", bam, *flags, "-o", out], [out])
    bed = tmp_path / "r.bed"
    bed.write_text("c1\t0\t50\nc1\t50\t300\nc1\t250\t400\nc2\t0\t10\n")
    both(capsys, ["bedcov", str(bed), bam])
    both(capsys, ["bedcov", str(bed), bam, "-F", "0"])
    bad = tmp_path / "bad.bed"
    bad.write_text("cX\t0\t50\n")
    both_exit(capsys, ["bedcov", str(bad), bam])


def test_faidx_and_fasta_index(tmp_path, capsys):
    import random

    rng = random.Random(5)
    seq = "".join(rng.choice("ACGT") for _ in range(437))
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        f.write(">chrT desc\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i : i + 70] + "\n")
    both(capsys, ["index", ref], [ref + ".fai"])
    out = str(tmp_path / "o.fa")
    both(capsys, ["faidx", ref, "chrT:11-70", "chrT", "chrT:400-", "chrT:1,00-2,00"])
    both(capsys, ["faidx", ref, "chrT:11-70", "-o", out], [out])
    both_exit(capsys, ["faidx", ref, "nope:1-10"])
    both_exit(capsys, ["faidx", ref, "chrT:50-10"])


def test_vcf_index(tmp_path, capsys):
    from denovo_kmer_tpu.io.vcf import VcfRecord, write_vcf

    recs = [VcfRecord("chr1", i * 1000 + 1, ".", "A", ["T"], None, ".", {}, [], [])
            for i in range(50)]
    p = str(tmp_path / "d.vcf.gz")
    write_vcf(p, recs, bgzf=True)
    both(capsys, ["index", p], [p + ".tbi"])


def test_bgzip(tmp_path, capsys):
    src = tmp_path / "t.txt"
    src.write_bytes(b"line one\n" + b"x" * 200_000 + b"\nend\n")
    gz = str(src) + ".gz"
    both(capsys, ["bgzip", str(src)], [gz])
    both(capsys, ["bgzip", "-r", gz], [gz + ".gzi"])
    out = str(tmp_path / "back.txt")
    both(capsys, ["bgzip", "-d", gz, "-o", out], [out])
    assert _read(out) == _read(src)
    other = str(tmp_path / "o.bgz")
    both(capsys, ["bgzip", str(src), "-o", other], [other])
    plain = tmp_path / "p.vcf.gz"
    plain.write_bytes(__import__("gzip").compress(b"hi"))
    both_exit(capsys, ["bgzip", "-d", str(plain), "-o", str(tmp_path / "no")])
    both_exit(capsys, ["bgzip", "-r", str(plain)])
    both_exit(capsys, ["bgzip", "-d", str(src)])


def test_doctor_lines_and_mesh(capsys):
    assert port_main(["doctor"]) == 0
    out = capsys.readouterr().out
    for key in ("python", "torch", "C++ shim", "nvcc", "codecs", "defaults"):
        assert any(line.startswith(key) for line in out.splitlines()), key
    assert "jax" not in out and "v5e" not in out
    assert port_main(["doctor", "--mesh", "2x4", "--device", "cpu"]) == 0
    assert "mesh        2x4: table axis local" in capsys.readouterr().out
    if not __import__("torch").cuda.is_available():
        assert port_main(["doctor", "--mesh", "2x2"]) == 0
        assert "mesh        2x2: UNBUILDABLE (CUDA was requested" in capsys.readouterr().out


def test_doctor_probe_feed_verdicts(trio_dir, capsys, monkeypatch):
    from denovo_kmer_tpu_torch import cli

    argv = ["doctor", "--probe-feed", str(trio_dir / "child.bam"), "--probe-batches", "2"]
    monkeypatch.setenv("DENOVO_CHIP_KMERS_PER_SEC", "1e15")
    assert port_main(argv) == 1
    out = capsys.readouterr().out
    assert "feed probe" in out and "WARNING" in out and "reads/s" in out
    assert "H100" in out and "700 W" in out
    monkeypatch.setenv("DENOVO_CHIP_KMERS_PER_SEC", "1")
    assert port_main(argv) == 0
    assert "feeder OK" in capsys.readouterr().out
    monkeypatch.delenv("DENOVO_CHIP_KMERS_PER_SEC")
    assert port_main(argv) in (0, 1)
    out = capsys.readouterr().out
    assert f"~{cli._CHIP_DEMAND_DEFAULT / 1e6:.0f} Mk-mers/s/card" in out
    assert cli._CHIP_DEMAND_DEFAULT != 175e6  # the TPU's number stays out of the port


def test_merged_table_equals_the_sum_of_its_inputs(trio_dir, tmp_path, capsys):
    """The port's merge against a numpy reference over the input tables."""
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.ops.table import table_to_numpy
    from denovo_kmer_tpu_torch.utils.checkpoint import load_table

    out = str(tmp_path / "m.npz")
    assert port_main(["merge", str(trio_dir / "mom.npz"), str(trio_dir / "dad.npz"), "-o",
                      out, *ENGINE_ARGS, *CPU]) == 0
    capsys.readouterr()
    cfg = EngineConfig(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13)
    ref = {}
    for name in ("mom", "dad"):
        keys, counts, n = table_to_numpy(load_table(str(trio_dir / f"{name}.npz"), cfg,
                                                    device="cpu"))
        for k, c in zip(map(tuple, keys[:n]), counts[:n]):
            ref[k] = ref.get(k, 0) + int(c)
    keys, counts, n = table_to_numpy(load_table(out, cfg, device="cpu"))
    assert n == len(ref)
    assert [tuple(k) for k in keys[:n]] == sorted(ref)
    np.testing.assert_array_equal(counts[:n], [ref[k] for k in sorted(ref)])
