"""The port's CRAM reader and writer (denovo_kmer_tpu_torch/io/cram.py), its CRAI index
(io/crai.py) and the columnar packed feeder (ops/pack.pack_chunks) against the JAX package
on the CPU: CRAM 3.0 and 3.1, mapped and unmapped, the core-block profile and multi-reference
slices. The port's writer writes the JAX writer's bytes; records read through the port equal
the JAX reader's; pack_chunks over iter_seq_chunks is bit-identical to pack_records and to
the JAX pack_chunks; CRAI files hold the same entries and region queries give the same
records; `run_trio` on a CRAM trio gives the JAX report. Tolerance: equal."""

import dataclasses
import gzip
import random
import threading

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.io import crai as jax_crai
from denovo_kmer_tpu.io import cram as jax_cram
from denovo_kmer_tpu.ops.pack import pack_chunks as jax_pack_chunks
from denovo_kmer_tpu.pipeline import run_trio as jax_run_trio
from denovo_kmer_tpu_torch import pipeline
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io import crai, cram
from denovo_kmer_tpu_torch.ops import pack
from denovo_kmer_tpu_torch.pipeline import TableOverflowError, run_trio

from _torch_inputs import write_inputs

torch.set_num_threads(1)

CFG = dict(k=21, max_read_len=64, batch_reads=37, table_capacity=1 << 13, accum_batches=4)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("cram_inputs"))


def _reads(seed, n=120, L=(1, 90)):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        s = "".join(rng.choice("ACGTN") for _ in range(rng.randrange(*L)))
        out.append((s, [rng.randrange(0, 41) for _ in s], rng.choice([0, 4, 16, 1024])))
    return out


def _mapped(seed, n=120, L=70, refs=None):
    rng = random.Random(seed)
    refs = refs or {0: "".join(rng.choice("ACGT") for _ in range(3000))}
    recs = []
    for _ in range(n):
        rid = rng.choice(sorted(refs))
        pos = rng.randrange(0, len(refs[rid]) - L)
        seq = list(refs[rid][pos:pos + L])
        for _ in range(rng.randrange(0, 3)):
            j = rng.randrange(L)
            seq[j] = rng.choice([b for b in "ACGT" if b != seq[j]])
        recs.append(("".join(seq), pos + 1, rid) if len(refs) > 1 else ("".join(seq), pos + 1))
    return refs, recs


# (version, method, rANS order, profile, mapped / multi-reference)
CASES = {
    "3.0-gzip-unmapped": ((3, 0), jax_cram.M_GZIP, 0, "external", None),
    "3.0-rans1-unmapped": ((3, 0), jax_cram.M_RANS, 1, "external", None),
    "3.0-rans0-mapped": ((3, 0), jax_cram.M_RANS, 0, "external", "mapped"),
    "3.0-core-unmapped": ((3, 0), jax_cram.M_RANS, 1, "core", None),
    "3.0-bzip2-multiref": ((3, 0), jax_cram.M_BZIP2, 0, "external", "multiref"),
    "3.1-nx16-unmapped": ((3, 1), jax_cram.M_RANSNX16, 1, "external", None),
    "3.1-nx16-mapped": ((3, 1), jax_cram.M_RANSNX16, 0, "external", "mapped"),
    "3.1-arith-mapped": ((3, 1), jax_cram.M_ARITH, 1, "external", "mapped"),
    "3.1-fqz-unmapped": ((3, 1), jax_cram.M_FQZCOMP, 0, "external", None),
    "3.1-tok3-unmapped": ((3, 1), jax_cram.M_TOK3, 0, "external", None),
    "3.1-lzma-multiref": ((3, 1), jax_cram.M_LZMA, 0, "external", "multiref"),
}


def _write_case(case, path, writer):
    version, method, order, profile, kind = CASES[case]
    kw = dict(method=method, rans_order=order, version=version, profile=profile,
              reads_per_container=45)
    if kind is None:
        writer(path, _reads(len(case)), **kw)
        return None
    refs = None
    if kind == "multiref":
        rng = random.Random(5)
        refs = {0: "".join(rng.choice("ACGT") for _ in range(2000)),
                1: "".join(rng.choice("ACGT") for _ in range(1500))}
    refs, recs = _mapped(len(case), refs=refs)
    hdr = "@HD\tVN:1.6\n" + "".join(f"@SQ\tSN:ref{i}\tLN:{len(s)}\n" for i, s in refs.items())
    writer(path, [], mapped=recs, reference=refs if kind == "multiref" else refs[0],
           sam_header=hdr, **kw)
    return {f"ref{i}": s for i, s in refs.items()}


def _records(reader_cls, path, ref):
    with open(path, "rb") as f:
        return [dataclasses.astuple(r) for r in reader_cls(f, reference=ref)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_writer_bytes_and_records_match_jax(case, tmp_path):
    want_path, got_path = str(tmp_path / "jax.cram"), str(tmp_path / "port.cram")
    ref = _write_case(case, want_path, jax_cram.write_cram)
    _write_case(case, got_path, cram.write_cram)
    with open(want_path, "rb") as a, open(got_path, "rb") as b:
        assert a.read() == b.read()
    want = _records(jax_cram.CramReader, want_path, ref)
    assert _records(cram.CramReader, want_path, ref) == want and want
    if ref is None:
        assert [dataclasses.astuple(r) for r in cram.read_cram_records(want_path)] == want


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.n_reads == b.n_reads
        for f in ("words", "vwords", "length"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("sample", ["mom", "dad", "child"])
@pytest.mark.parametrize("minq", [0, 20])
def test_pack_chunks_matches_pack_records_and_jax(inputs, sample, minq):
    """The columnar feeder of each sample's codec: batches of 37 reads cross the
    100-record slices, and max_read_len 64 truncates the 60 bp reads' longer cousins."""
    path, ref = inputs[sample]["cram"], cram.load_reference(inputs["reference"])
    cfg = EngineConfig(**CFG, min_base_quality=minq)
    jcfg = JaxConfig(**CFG, min_base_quality=minq)

    def chunks(mod, c):
        with open(path, "rb") as f:
            return list(mod.CramReader(f, reference=ref).iter_seq_chunks(
                c.filter_flag_mask, c.max_read_len, with_quals=minq > 0))

    got = list(pack.pack_chunks(chunks(cram, cfg), cfg))
    with open(path, "rb") as f:
        _batches_equal(got, list(pack.pack_records(cram.CramReader(f, reference=ref), cfg)))
    _batches_equal(got, list(jax_pack_chunks(chunks(jax_cram, jcfg), jcfg)))


def test_packed_batches_takes_the_columnar_feeder(inputs, monkeypatch):
    """A local CRAM with no region goes through pack_chunks; min_base_quality > 255 (no
    byte sentinel) sends it back to the record loop, as in the JAX package. Same batches."""
    path = inputs["child"]["cram"]
    calls = []
    real = pack.pack_chunks
    monkeypatch.setattr(pack, "pack_chunks", lambda *a: calls.append(1) or real(*a))
    cfg = EngineConfig(**CFG, reference_fasta=inputs["reference"], min_base_quality=20)
    got = list(pipeline.packed_batches(path, cfg))
    assert calls == [1]
    want = list(pack.pack_records(pipeline._record_stream(path, cfg), cfg))
    _batches_equal(got, want)
    hi = dataclasses.replace(cfg, min_base_quality=300)
    list(pipeline.packed_batches(path, hi))
    assert calls == [1]


def test_crai_matches_jax(inputs, tmp_path):
    """The same index entries (the gzip member's header carries a timestamp and the file
    name, so the decompressed text is compared) and the same region records, through the
    index and by full scan."""
    path = inputs["mom"]["cram"]
    assert [dataclasses.astuple(e) for e in crai.build_crai(path)] == \
        [dataclasses.astuple(e) for e in jax_crai.build_crai(path)]
    got = crai.write_crai(path, str(tmp_path / "port.crai"))
    want = jax_crai.write_crai(path, str(tmp_path / "jax.crai"))
    with gzip.open(got, "rb") as a, gzip.open(want, "rb") as b:
        text = a.read()
        assert text == b.read() and text.count(b"\n") >= 3
    assert [dataclasses.astuple(e) for e in crai.read_crai(got)] == \
        [dataclasses.astuple(e) for e in jax_crai.read_crai(want)]
    ref = inputs["reference"]
    for region in ("chr20:1-500", "chr20:1200-1900", "chr20:2990-3000", "chr20"):
        want_recs = [dataclasses.astuple(r) for r in jax_crai.read_cram_records_region(
            path, region, reference=jax_cram.load_reference(ref))]
        got_recs = [dataclasses.astuple(r) for r in crai.read_cram_records_region(
            path, region, reference=cram.load_reference(ref))]
        assert got_recs == want_recs and want_recs
        unindexed = tmp_path / "noidx.cram"
        unindexed.write_bytes(open(path, "rb").read())
        assert [dataclasses.astuple(r) for r in crai.read_cram_records_region(
            str(unindexed), region, reference=cram.load_reference(ref))] == want_recs


@pytest.mark.parametrize("what", ["cram", "cram_region"])
def test_run_trio_on_cram_matches_jax(inputs, what):
    region = "chr20:800-2200" if what == "cram_region" else None
    paths = [inputs[s]["cram"] for s in ("mom", "dad", "child")]
    cfg = dict(CFG, reference_fasta=inputs["reference"])
    got = run_trio(*paths, EngineConfig(**cfg), region=region, device="cpu")
    want = jax_run_trio(*paths, JaxConfig(**cfg), region=region)
    assert got.report == want.report and got.tables_n == want.tables_n
    assert got.report.count("\n") > 1
    bams = [inputs[s]["bam"] for s in ("mom", "dad", "child")]
    assert run_trio(*bams, EngineConfig(**cfg), region=region, device="cpu").report \
        == got.report


def test_overflow_mid_cram_stream_stops_every_thread(inputs):
    """A TableOverflowError raised while the columnar feeder's container pool and the
    port's prefetch thread are both running ends the run and leaves no thread behind."""
    before = set(threading.enumerate())
    paths = [inputs[s]["cram"] for s in ("mom", "dad", "child")]
    cfg = EngineConfig(**dict(CFG, table_capacity=256, reference_fasta=inputs["reference"]))
    with pytest.raises(TableOverflowError):
        run_trio(*paths, cfg, device="cpu")
    for t in set(threading.enumerate()) - before:
        t.join(timeout=30)
        assert not t.is_alive(), t.name
