"""The port's VCF, BCF and tabix modules (denovo_kmer_tpu_torch/io/{vcf,bcf,tabix}.py) against
the JAX package's, on tests/test_vcf.py, test_bcf.py and test_tabix.py's inputs: the same
records give byte-equal .vcf, .vcf.gz, .bcf and .tbi files, each package reads the other's
files into equal records, region queries return the same records, the same inputs are
refused with the same messages, and the synthetic truth VCF is byte-equal, plain and BGZF."""

import dataclasses
import gzip
import random

import pytest

from denovo_kmer_tpu.io import bcf as J_bcf
from denovo_kmer_tpu.io import synth as J_synth
from denovo_kmer_tpu.io import tabix as J_tabix
from denovo_kmer_tpu.io import vcf as J_vcf
from denovo_kmer_tpu_torch.io import bcf as P_bcf
from denovo_kmer_tpu_torch.io import synth as P_synth
from denovo_kmer_tpu_torch.io import tabix as P_tabix
from denovo_kmer_tpu_torch.io import vcf as P_vcf
from test_bcf import CONTIGS as BCF_CONTIGS
from test_bcf import SAMPLES as BCF_SAMPLES
from test_bcf import _mk_records as bcf_records
from test_tabix import CONTIGS as TBX_CONTIGS
from test_tabix import _mk_records as tbx_records

EXTRA_META = ['##FILTER=<ID=q10,Description="q">', '##FILTER=<ID=s50,Description="s">']


def _as_port(recs):
    return [P_vcf.VcfRecord(**dataclasses.asdict(r)) for r in recs]


def _fields(recs):
    return [dataclasses.asdict(r) for r in recs]


def _vcf_examples():
    first = [
        J_vcf.VcfRecord(chrom="chr1", pos=100, id="rs1", ref="A", alts=["T"], qual=50.0,
                        filter="PASS", info={"DP": "30", "DB": True}, format=["GT", "DP"],
                        samples=[{"GT": "0/1", "DP": "15"}, {"GT": "1/1", "DP": "22"}]),
        J_vcf.VcfRecord(chrom="chr1", pos=250, id=".", ref="GT", alts=["G", "GTT"],
                        qual=None, filter=".", info={}, format=["GT"],
                        samples=[{"GT": "0/2"}, {"GT": "."}]),
    ]
    return [(first, ["s1", "s2"], [("chr1", 10_000)]),
            (bcf_records(random.Random(1)), BCF_SAMPLES, BCF_CONTIGS)]


@pytest.mark.parametrize("bgzf", [False, True])
def test_vcf_files_byte_equal_and_cross_readable(tmp_path, bgzf):
    for i, (recs, samples, contigs) in enumerate(_vcf_examples()):
        jp, pp = str(tmp_path / f"j{i}.vcf"), str(tmp_path / f"p{i}.vcf")
        J_vcf.write_vcf(jp, recs, contigs=contigs, samples=samples, bgzf=bgzf,
                        extra_meta=EXTRA_META)
        P_vcf.write_vcf(pp, _as_port(recs), contigs=contigs, samples=samples, bgzf=bgzf,
                        extra_meta=EXTRA_META)
        assert open(jp, "rb").read() == open(pp, "rb").read()
        want = _fields(J_vcf.read_vcf_records(jp))
        assert _fields(P_vcf.read_vcf_records(jp)) == want
        assert _fields(P_vcf.read_vcf_records(pp)) == want
        with J_vcf.VcfReader(jp) as a, P_vcf.VcfReader(pp) as b:
            assert (a.samples, a.meta) == (b.samples, b.meta)


def test_vcf_plain_gzip_and_rejections_match(tmp_path):
    recs, samples, contigs = _vcf_examples()[0]
    p = str(tmp_path / "x.vcf")
    J_vcf.write_vcf(p, recs, contigs=contigs, samples=samples)
    gz = tmp_path / "x.vcf.gz"
    gz.write_bytes(gzip.compress(open(p, "rb").read()))
    assert _fields(P_vcf.read_vcf_records(str(gz))) == _fields(J_vcf.read_vcf_records(p))
    bad = tmp_path / "bad.vcf"
    bad.write_text("not a vcf\n")
    two = tmp_path / "two.vcf"
    two.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                   "chr1\t5\t.\tA\n")
    for path in (bad, two):
        errs = []
        for mod in (J_vcf, P_vcf):
            with pytest.raises(ValueError) as e:
                list(mod.read_vcf_records(str(path)))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("seed", range(12))
def test_bcf_byte_equal_and_cross_readable(tmp_path, seed):
    recs = bcf_records(random.Random(seed), n=10 + 5 * seed)
    jp, pp = str(tmp_path / "j.bcf"), str(tmp_path / "p.bcf")
    J_bcf.write_bcf(jp, recs, contigs=BCF_CONTIGS, samples=BCF_SAMPLES)
    P_bcf.write_bcf(pp, _as_port(recs), contigs=BCF_CONTIGS, samples=BCF_SAMPLES)
    assert open(jp, "rb").read() == open(pp, "rb").read()
    want = _fields(J_bcf.read_bcf_records(jp))
    assert _fields(P_bcf.read_bcf_records(jp)) == want
    assert _fields(P_bcf.read_bcf_records(pp)) == want
    with J_bcf.BcfReader(jp) as a, P_bcf.BcfReader(pp) as b:
        assert (a.samples, a.meta) == (b.samples, b.meta)


def test_bcf_edge_records_and_errors_match(tmp_path):
    recs = [J_vcf.VcfRecord("c", 1, ".", "A", ["T", "G"], None, ".", {}, ["GT"],
                            [{"GT": "2|1"}, {"GT": "."}, {"GT": "0/2"}, {"GT": "1"}]),
            J_vcf.VcfRecord("c", 2, ".", "A", ["T"], 31.5, "PASS", {}, ["GT"],
                            [{"GT": "0/1"}] * 4)]
    jp, pp = str(tmp_path / "j.bcf"), str(tmp_path / "p.bcf")
    J_bcf.write_bcf(jp, recs, samples=list("abcd"))
    P_bcf.write_bcf(pp, _as_port(recs), samples=list("abcd"))
    assert open(jp, "rb").read() == open(pp, "rb").read()
    bad = [J_vcf.VcfRecord("c", 1, ".", "A", ["T"], None, ".", {}, ["GT"], [{"GT": "A|1"}])]
    for mod, rs in ((J_bcf, bad), (P_bcf, _as_port(bad))):
        with pytest.raises(ValueError, match="malformed GT"):
            mod.write_bcf(str(tmp_path / "m.bcf"), rs, samples=["s"])
    (tmp_path / "t.bcf").write_bytes(open(jp, "rb").read()[:-40])
    errs = []
    for mod in (J_bcf, P_bcf):
        with pytest.raises(Exception) as e:
            list(mod.read_bcf_records(str(tmp_path / "t.bcf")))
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


@pytest.fixture(scope="module")
def vcf_gz(tmp_path_factory):
    recs = tbx_records(random.Random(5), TBX_CONTIGS, 300)
    recs.append(J_vcf.VcfRecord(chrom="chr1", pos=50_001, id="sv1", ref="N",
                                alts=["<DEL>"], qual=None, filter="PASS",
                                info={"SVTYPE": "DEL", "END": "120000"},
                                format=[], samples=[]))
    order = {c: i for i, (c, _) in enumerate(TBX_CONTIGS)}
    recs.sort(key=lambda r: (order[r.chrom], r.pos))
    d = tmp_path_factory.mktemp("torch_tbx")
    path = str(d / "x.vcf.gz")
    J_vcf.write_vcf(path, recs, contigs=TBX_CONTIGS, bgzf=True)
    return path


def test_tbi_byte_equal_and_regions_match(vcf_gz, tmp_path):
    jt, pt = str(tmp_path / "j.tbi"), str(tmp_path / "p.tbi")
    J_tabix.write_tbi(vcf_gz, jt)
    P_tabix.write_tbi(vcf_gz, pt)
    assert open(jt, "rb").read() == open(pt, "rb").read()
    (ji, jn), (pi, pn) = J_tabix.read_tbi(jt), P_tabix.read_tbi(jt)
    assert jn == pn and len(ji.refs) == len(pi.refs)
    for a, b in zip(ji.refs, pi.refs):
        assert a.bins == b.bins and a.linear == b.linear
    for region in ("chr1", "chr2", "chr1:1-5000", "chr1:50000-50010", "chr1:110000-130000",
                   "chr2:1000-90000", "chr1:299000-300000"):
        assert _fields(P_tabix.read_vcf_region(vcf_gz, region, jt)) == _fields(
            J_tabix.read_vcf_region(vcf_gz, region, jt)), region


def test_tabix_rejections_match(tmp_path):
    p = tmp_path / "p.vcf.gz"
    p.write_bytes(gzip.compress(b"##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT"
                                b"\tQUAL\tFILTER\tINFO\nchr1\t5\t.\tA\tT\t.\t.\t.\n"))
    unsorted = [J_vcf.VcfRecord("chr1", 100, ".", "A", ["T"], None, ".", {}, [], []),
                J_vcf.VcfRecord("chr1", 50, ".", "A", ["T"], None, ".", {}, [], [])]
    u = str(tmp_path / "u.vcf.gz")
    J_vcf.write_vcf(u, unsorted, bgzf=True)
    for path in (str(p), u):
        errs = []
        for mod in (J_tabix, P_tabix):
            with pytest.raises(ValueError) as e:
                mod.write_tbi(path, str(tmp_path / "x.tbi"))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("bgzf", [False, True])
def test_truth_vcf_byte_equal(tmp_path, bgzf):
    spec = dict(genome_len=4000, seed=11, n_denovo_snvs=4)
    jp, pp = str(tmp_path / "j.vcf"), str(tmp_path / "p.vcf")
    J_synth.write_truth_vcf(J_synth.make_trio(J_synth.TrioSpec(**spec)), jp, bgzf=bgzf)
    P_synth.write_truth_vcf(P_synth.make_trio(P_synth.TrioSpec(**spec)), pp, bgzf=bgzf)
    assert open(jp, "rb").read() == open(pp, "rb").read()
