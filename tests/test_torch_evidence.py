"""The port's candidate evidence (denovo_kmer_tpu_torch/pipeline.py: run_evidence and its
helpers, io/sam.py's writer half) against the JAX package's run_evidence on the CPU, on the
fixture of tests/test_evidence.py: BAM, SAM and FASTQ outputs and the per-candidate TSV
byte-equal, for a BAM child, a FASTQ child, and SAM, CRAM and remote children.
Tolerance: byte-equal."""

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.io.sam import format_sam_record as jax_format_sam_record
from denovo_kmer_tpu.io.sam import sam_header_lines as jax_sam_header_lines
from denovo_kmer_tpu.pipeline import candidate_table as jax_candidate_table
from denovo_kmer_tpu.pipeline import candidate_words_from_tsv as jax_candidate_words
from denovo_kmer_tpu.pipeline import run_evidence as jax_run_evidence
from denovo_kmer_tpu.pipeline import source_header as jax_source_header
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.io.sam import format_sam_record, sam_header_lines
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops import extract
from denovo_kmer_tpu_torch.ops.table import table_to_numpy
from denovo_kmer_tpu_torch.pipeline import (
    candidate_read_batches,
    candidate_table,
    candidate_words_from_tsv,
    parse_candidates_tsv,
    run_evidence,
    run_trio,
    source_header,
)

torch.set_num_threads(1)

CFG = dict(k=21, max_read_len=80, batch_reads=64, table_capacity=1 << 14, min_child_count=2)
SPEC = TrioSpec(genome_len=3000, read_len=80, coverage=6.0, n_denovo_snvs=4, seed=33)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """tests/test_evidence.py's trio, its call report as the candidate TSV, and the child
    as FASTQ."""
    d = tmp_path_factory.mktemp("ev")
    paths = write_trio_bams(make_trio(SPEC), str(d))
    cfg = EngineConfig(**CFG)
    res = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cpu")
    assert res.candidates, "fixture produced no candidates"
    tsv = str(d / "cands.tsv")
    with open(tsv, "w") as f:
        f.write(res.report)
    fq = str(d / "child.fastq")
    with open(fq, "w") as f:
        for r in read_bam_records(paths["child"]):
            if r.flag & cfg.filter_flag_mask:
                continue
            q = "".join(chr((x or 0) + 33) for x in (r.qual or [0] * len(r.seq)))
            f.write(f"@{r.name}\n{r.seq}\n+\n{q}\n")
    return d, paths, tsv, fq


def _both(child, tsv, out_dir, ext, per_candidate=False, **cfg_kw):
    """Run both packages' run_evidence; → (port result, JAX result, port bytes, JAX bytes,
    per-candidate texts)."""
    out = {}
    for pkg in ("port", "jax"):
        o = str(out_dir / f"{pkg}.{ext}")
        pc = str(out_dir / f"{pkg}.per_candidate.tsv") if per_candidate else None
        if pkg == "port":
            res = run_evidence(child, tsv, EngineConfig(**{**CFG, **cfg_kw}), o,
                               per_candidate_out=pc, device="cpu")
        else:
            res = jax_run_evidence(child, tsv, JaxConfig(**{**CFG, **cfg_kw}), o,
                                   per_candidate_out=pc)
        with open(o, "rb") as f:
            data = f.read()
        text = open(pc).read() if pc else None
        out[pkg] = (res, data, text)
    return out


@pytest.mark.parametrize("ext", ["bam", "sam", "fastq"])
def test_evidence_matches_jax(trio, tmp_path, ext):
    _, paths, tsv, _ = trio
    out = _both(paths["child"], tsv, tmp_path, ext)
    (res, data, _), (jres, jdata, _) = out["port"], out["jax"]
    assert (res.n_reads_scanned, res.n_reads_matched) == (jres.n_reads_scanned,
                                                          jres.n_reads_matched)
    assert res.n_reads_matched > 0
    assert data == jdata


@pytest.mark.parametrize("ext", ["bam", "fastq"])
def test_evidence_fastq_child_matches_jax(trio, tmp_path, ext):
    """A FASTQ child has no alignment fields: sequence-level BAM rows (unmapped, refless)
    or FASTQ records, as in the JAX package."""
    _, _, tsv, fq = trio
    out = _both(fq, tsv, tmp_path, ext)
    assert out["port"][0].n_reads_matched == out["jax"][0].n_reads_matched > 0
    assert out["port"][1] == out["jax"][1]


def test_per_candidate_matches_jax(trio, tmp_path):
    _, paths, tsv, _ = trio
    out = _both(paths["child"], tsv, tmp_path, "bam", per_candidate=True)
    assert out["port"][2] == out["jax"][2]
    assert out["port"][2].count("\n") == 1 + len(parse_candidates_tsv(tsv))


def test_evidence_with_quality_mask_matches_jax(trio, tmp_path):
    """min_base_quality masks bases to invalid: windows over them never match."""
    _, paths, tsv, _ = trio
    out = _both(paths["child"], tsv, tmp_path, "sam", per_candidate=True,
                min_base_quality=30)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]


def test_evidence_empty_candidates_matches_jax(trio, tmp_path):
    _, paths, _, _ = trio
    empty = str(tmp_path / "none.tsv")
    with open(empty, "w") as f:
        f.write("#kmer\tchild_count\tmom_count\tdad_count\n")
    out = _both(paths["child"], empty, tmp_path, "bam")
    assert out["port"][0].n_reads_matched == 0
    assert out["port"][1] == out["jax"][1]
    assert list(read_bam_records(str(tmp_path / "port.bam"))) == []


def test_candidate_length_mismatch_rejected(trio, tmp_path):
    _, paths, _, _ = trio
    bad = str(tmp_path / "bad.tsv")
    with open(bad, "w") as f:
        f.write("ACGT\t1\t0\t0\n")
    for run, cfg in ((run_evidence, EngineConfig(**CFG)), (jax_run_evidence, JaxConfig(**CFG))):
        kw = {"device": "cpu"} if run is run_evidence else {}
        with pytest.raises(ValueError, match="has length 4, expected k=21"):
            run(paths["child"], bad, cfg, str(tmp_path / "x.bam"), **kw)


def test_candidate_table_matches_jax(trio, tmp_path):
    """Words and the sorted, deduplicated membership table; a non-numeric count column
    parses as 0 in both."""
    _, _, tsv, _ = trio
    lines = open(tsv).read().splitlines()
    messy = str(tmp_path / "messy.tsv")
    with open(messy, "w") as f:  # duplicates, lower case, a non-numeric count
        f.write("\n".join(lines + [lines[1].lower(), lines[2].split("\t")[0] + "\tx"]) + "\n")
    for path in (tsv, messy):
        words = candidate_words_from_tsv(path, EngineConfig(**CFG))
        np.testing.assert_array_equal(words, jax_candidate_words(path, JaxConfig(**CFG)))
        got, want = candidate_table(words), jax_candidate_table(words)
        keys, counts, n = table_to_numpy(got)
        assert n == int(want.n)
        np.testing.assert_array_equal(keys, np.asarray(want.keys))
        np.testing.assert_array_equal(counts, np.asarray(want.counts))
    empty = np.zeros((0, 1), np.uint32)
    assert table_to_numpy(candidate_table(empty))[0].shape == np.asarray(
        jax_candidate_table(empty).keys).shape


def test_sam_writer_and_source_header_match_jax(trio):
    _, paths, _, fq = trio
    refs, header = source_header(paths["child"])
    assert (refs, header) == tuple(jax_source_header(paths["child"]))
    assert source_header(fq) == tuple(jax_source_header(fq))
    names = [n for n, _ in refs]
    assert sam_header_lines(refs) == jax_sam_header_lines(refs)
    for r in list(read_bam_records(paths["child"]))[:50]:
        assert format_sam_record(r, names) == jax_format_sam_record(r, names)


@pytest.mark.parametrize("path", ["child.sam", "child.cram", "http://host/child.bam"])
def test_unported_sources_raise(trio, tmp_path, path):
    """SAM, CRAM and remote children, refused before the port read them, now give the JAX
    package's evidence BAM and header (the CRAM reference-based, written by the JAX
    writer; the URL served from a local HTTP server)."""
    from denovo_kmer_tpu.io.cram import M_RANS, write_cram
    from denovo_kmer_tpu.io.sam import write_sam

    from _torch_inputs import serve

    d, paths, tsv, _ = trio
    recs = list(read_bam_records(paths["child"]))
    refs = source_header(paths["child"])[0]
    cfg_kw = {}
    if path == "child.sam":
        source = write_sam(str(tmp_path / path), recs, references=refs)
    elif path == "child.cram":
        trio_ref = make_trio(SPEC).reference
        ref_fa = tmp_path / "ref.fa"
        ref_fa.write_text(f">{refs[0][0]}\n{trio_ref}\n")
        source = str(tmp_path / path)
        write_cram(source, [], mapped=[(r.seq, r.pos + 1, r.flag, r.qual) for r in recs],
                   reference=trio_ref, method=M_RANS, rans_order=1,
                   sam_header=f"@HD\tVN:1.6\n@SQ\tSN:{refs[0][0]}\tLN:{refs[0][1]}\n")
        cfg_kw = dict(reference_fasta=str(ref_fa))
    with serve(d) as url:
        if path.startswith("http://"):
            source = path.replace("http://host", url)
        assert source_header(source) == tuple(jax_source_header(source))
        out = _both(source, tsv, tmp_path, "bam", **cfg_kw)
    assert out["port"][0].n_reads_matched == out["jax"][0].n_reads_matched > 0
    assert out["port"][1] == out["jax"][1]


def test_one_extraction_a_batch(trio, monkeypatch):
    """The device step extracts each batch once, through extract_append (its plain version
    on the CPU), and its hit mask covers exactly the batch's reads."""
    _, paths, tsv, _ = trio
    calls = []
    real = extract.append_plain

    def counted(acc, words, *a, **kw):
        calls.append(words.shape[0])
        return real(acc, words, *a, **kw)

    monkeypatch.setattr(extract, "append_plain", counted)
    cfg = EngineConfig(**CFG)
    table = candidate_table(candidate_words_from_tsv(tsv, cfg))
    batches = list(candidate_read_batches(paths["child"], table, cfg))
    assert len(calls) == len(batches) > 1
    assert all(c == cfg.batch_reads for c in calls)
    assert all(len(b) == len(m) for b, m in batches)


@pytest.mark.cuda
def test_evidence_on_cuda_equals_cpu(trio, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 3 runs this on the H100)")
    _, paths, tsv, _ = trio
    for ext in ("bam", "sam", "fastq"):
        data = {}
        for dev in ("cuda", "cpu"):
            o = str(tmp_path / f"{dev}.{ext}")
            run_evidence(paths["child"], tsv, EngineConfig(**CFG), o, device=dev)
            data[dev] = open(o, "rb").read()
        assert data["cuda"] == data["cpu"]
