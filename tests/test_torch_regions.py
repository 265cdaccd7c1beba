"""Region-restricted input in the port (denovo_kmer_tpu_torch/io/bai.py and the region
dispatch of pipeline._record_stream / cli._resolve_region) against the JAX package on the
CPU, on tests/test_bai.py's cases: `write_bai`/`write_csi` write the same bytes, region and
multi-region reads give the same records through an index and by full scan, `parse_region`,
`parse_bed`, the bins and `index_stats` agree, `run_trio` with `--region` and with
`--regions-bed` gives the JAX report, and the CLI refuses what the JAX CLI refuses.
Tolerance: equal."""

import os
import random
import shutil

import pytest
import torch

from denovo_kmer_tpu import cli as jax_cli
from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.io import bai as jax_bai
from denovo_kmer_tpu.io.bam import BamRecord as JaxRecord
from denovo_kmer_tpu.io.bam import BamWriter as JaxWriter
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu_torch import cli
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io import bai
from denovo_kmer_tpu_torch.pipeline import _record_stream, run_trio

from _torch_inputs import write_inputs

torch.set_num_threads(1)

CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13, accum_batches=4)
REGIONS = ("chr20", "chr20:1-500", "chr20:1,200-1,900", "chr20:2990-3000", "chr20:1500")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("region_inputs"))


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    """tests/test_bai.py's two-contig BAM: long reads that span the gaps between BED
    intervals, coordinate-sorted, with its BAI."""
    rng = random.Random(77)
    refs = [("c1", 50_000), ("c2", 50_000)]
    recs = []
    for i in range(400):
        L = rng.choice([50, 400])
        recs.append(JaxRecord(name=f"r{i}", flag=0, refid=rng.randrange(2),
                              pos=rng.randrange(49_000), cigar=((L, 0),), seq="A" * L,
                              qual=tuple([30] * L)))
    recs.sort(key=lambda r: (r.refid, r.pos))
    d = tmp_path_factory.mktemp("two_contigs")
    bam = str(d / "s.bam")
    with open(bam, "wb") as f, JaxWriter(f, references=refs) as w:
        for r in recs:
            w.write(r)
    jax_bai.write_bai(bam)
    bed = d / "t.bed"
    bed.write_text("# targets\nc1\t1000\t2000\tnameA\t0\t+\nc1\t1900\t2500\n"
                   "c1\t2600\t2700\nc2\t10\t20\n")
    return bam, str(bed)


def _names(recs):
    return [(r.name, r.pos, r.flag, r.seq) for r in recs]


@pytest.mark.parametrize("fmt", ["bai", "csi"])
def test_index_writers_match_jax(inputs, tmp_path, fmt):
    bam = inputs["child"]["bam"]
    got = getattr(bai, f"write_{fmt}")(bam, str(tmp_path / f"port.{fmt}"))
    want = getattr(jax_bai, f"write_{fmt}")(bam, str(tmp_path / f"jax.{fmt}"))
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert bai.index_stats(got) == jax_bai.index_stats(want)


def test_index_refuses_unsorted(inputs, tmp_path):
    from denovo_kmer_tpu.io.bam import read_bam_records

    recs = list(read_bam_records(inputs["child"]["bam"]))
    unsorted = str(tmp_path / "u.bam")
    with open(unsorted, "wb") as f, JaxWriter(f, references=[("chr20", 3000)]) as w:
        for r in reversed(recs):
            w.write(r)
    for mod in (bai, jax_bai):
        with pytest.raises(ValueError, match="sort"):
            mod.write_bai(unsorted)


def test_regions_through_the_index_and_by_scan(inputs, tmp_path):
    """Every region gives the JAX records, through the BAI and through the full-scan
    filter of a copy with no index next to it."""
    bam = inputs["mom"]["bam"]
    bare = str(tmp_path / "bare.bam")
    shutil.copy(bam, bare)
    assert bai.load_index_for(bare) is None
    idx = bai.load_index_for(bam)
    assert idx is not None and len(idx.refs) == 1
    for region in REGIONS:
        want = _names(jax_bai.read_bam_records_region(bam, region))
        assert _names(bai.read_bam_records_region(bam, region)) == want, region
        assert _names(bai.read_bam_records_region(bare, region)) == want, region
        assert want or region == "chr20:2990-3000"
        csi = jax_bai.read_csi(jax_bai.write_csi(bam, str(tmp_path / "i.csi")))
        assert _names(bai.read_bam_records_region(bam, region, csi)) == want


def test_parse_region_bins_and_errors(inputs):
    refs = [("chr20", 3000), ("chrM", 16_569)]
    for text in ("chr20", "chr20:1-500", "chr20:1,200-1,900", "chrM:7", "chr20:10-"):
        assert bai.parse_region(text, refs) == jax_bai.parse_region(text, refs)
    for text, msg in (("chr1:1-10", "not in BAM header"), ("chr20:500-100", "empty region")):
        with pytest.raises(ValueError, match=msg):
            jax_bai.parse_region(text, refs)
        with pytest.raises(ValueError, match=msg):
            bai.parse_region(text, refs)
    for beg, end in ((0, 1), (16383, 16385), (1 << 20, (1 << 20) + 5000), (5, 1 << 26)):
        assert bai.reg2bin(beg, end) == jax_bai.reg2bin(beg, end)
        assert bai.reg2bins(beg, end) == jax_bai.reg2bins(beg, end)


def test_bed_regions_match_jax(two_contigs, tmp_path):
    """parse_bed merges overlapping intervals per contig; read_bam_records_regions yields
    each overlapping read once (samtools view -M -L), with and without the index."""
    bam, bed = two_contigs
    regions = bai.parse_bed(bed)
    assert regions == jax_bai.parse_bed(bed)
    want = _names(jax_bai.read_bam_records_regions(bam, regions))
    assert _names(bai.read_bam_records_regions(bam, regions)) == want
    assert len(want) == len(set(want)) > 0
    bare = str(tmp_path / "bare.bam")
    shutil.copy(bam, bare)
    assert _names(bai.read_bam_records_regions(bare, regions)) == want


@pytest.mark.parametrize("fmt", ["bam", "cram"])
@pytest.mark.parametrize("how", ["region", "regions_bed"])
def test_run_trio_region_matches_jax(inputs, tmp_path, fmt, how):
    if fmt == "cram" and how == "regions_bed":
        # the JAX package refuses a region list on CRAM; so does the port, with its message
        cfg = EngineConfig(**CFG, reference_fasta=inputs["reference"])
        for stream in (_record_stream, __import__(
                "denovo_kmer_tpu.pipeline", fromlist=["_record_stream"])._record_stream):
            with pytest.raises(ValueError, match="--regions-bed requires BAM"):
                stream(inputs["child"]["cram"], cfg, ["chr20:1-100"])
        return
    region = "chr20:700-2300"
    if how == "regions_bed":
        bed = tmp_path / "r.bed"
        bed.write_text("chr20\t100\t900\nchr20\t1500\t2300\n")
        region = bai.parse_bed(str(bed))
    paths = [inputs[s][fmt] for s in ("mom", "dad", "child")]
    cfg = dict(CFG, reference_fasta=inputs["reference"])
    got = run_trio(*paths, EngineConfig(**cfg), region=region, device="cpu")
    want = jax_run_trio(*paths, JaxConfig(**cfg), region=region)
    assert got.report == want.report and got.tables_n == want.tables_n
    assert got.metrics.counters["reads_ingested"] == want.metrics.counters["reads_ingested"]
    full = run_trio(*paths, EngineConfig(**cfg), device="cpu")
    assert 0 < got.metrics.counters["reads_ingested"] < full.metrics.counters["reads_ingested"]


def test_region_on_a_text_input_is_refused(inputs):
    cfg = EngineConfig(**CFG)
    with pytest.raises(ValueError, match="requires a BAM or CRAM"):
        _record_stream(inputs["child"]["sam"], cfg, "chr20:1-100")


@pytest.mark.parametrize("argv", [
    ["--region", "chr20:1-100", "--resume"],
    ["--regions-bed", "BED", "--resume"],
    ["--region", "chr20:1-100", "--regions-bed", "BED"],
])
def test_cli_region_refusals_match_jax(inputs, tmp_path, argv):
    """`count --resume` with a region, and --region beside --regions-bed, exit as the JAX
    CLI exits."""
    bed = tmp_path / "r.bed"
    bed.write_text("chr20\t100\t900\n")
    argv = [str(bed) if a == "BED" else a for a in argv]
    msgs = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["count", inputs["child"]["bam"], "-o", str(tmp_path / "t.npz"),
                  "-k", "21", *argv, *extra])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "mutually exclusive" in msgs[0]
    assert not os.path.exists(tmp_path / "t.npz")


@pytest.mark.parametrize("fmt", ["bam", "cram"])
def test_count_with_a_region_matches_jax(inputs, tmp_path, fmt):
    import numpy as np

    outs = {}
    for name, (main, extra) in {"jax": (jax_cli.main, []),
                                "port": (cli.main, ["--device", "cpu"])}.items():
        outs[name] = str(tmp_path / f"{name}.npz")
        assert main(["count", inputs["dad"][fmt], "-o", outs[name], "--region",
                     "chr20:500-1500", "--reference", inputs["reference"], "-k", "21",
                     "--max-read-len", "64", "--table-capacity", str(1 << 13), *extra]) == 0
    with np.load(outs["jax"]) as a, np.load(outs["port"]) as b:
        assert a["keys"].shape[0] > 0
        for f in ("keys", "counts"):
            np.testing.assert_array_equal(a[f], b[f])
