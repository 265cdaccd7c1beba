"""The port's host-side copies (config, metrics, oracle, BGZF/BAM/FASTQ codecs, prefetch)
against the JAX package's originals on the same inputs."""

import dataclasses
import io
import threading

import numpy as np
import pytest
import torch

from denovo_kmer_tpu import config as jconfig
from denovo_kmer_tpu.io import bam as jbam
from denovo_kmer_tpu.io import bgzf as jbgzf
from denovo_kmer_tpu.io.fasta import read_fasta as jax_read_fasta
from denovo_kmer_tpu.io.fasta import read_fastq as jax_read_fastq
from denovo_kmer_tpu.oracle import scalar as joracle
from denovo_kmer_tpu.io.prefetch import prefetch_placed as jax_prefetch_placed
from denovo_kmer_tpu.utils import metrics as jmetrics
from denovo_kmer_tpu.utils.metrics import Metrics as JaxMetrics
from denovo_kmer_tpu_torch import config as tconfig
from denovo_kmer_tpu_torch.io import bam as tbam
from denovo_kmer_tpu_torch.io import bgzf as tbgzf
from denovo_kmer_tpu_torch.io.fasta import read_fasta, read_fastq
from denovo_kmer_tpu_torch.io.prefetch import prefetch_batches, prefetch_placed
from denovo_kmer_tpu_torch.ops.pack import PackedReads, pack_seqs
from denovo_kmer_tpu_torch.oracle import scalar as toracle
from denovo_kmer_tpu_torch.utils import metrics as tmetrics
from denovo_kmer_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)


def test_engine_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.EngineConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.EngineConfig)]
    assert tf == jf
    cfg = dict(k=27, canonical=False, tau_parent=3, min_child_count=4, batch_reads=8,
               max_read_len=100, table_capacity=512, accum_batches=3, extractor="pallas")
    assert tconfig.EngineConfig(**cfg).config_hash() == jconfig.EngineConfig(**cfg).config_hash()
    assert tconfig.DEFAULT_FILTER_MASK == jconfig.DEFAULT_FILTER_MASK
    assert [tconfig.words_per_kmer(k) for k in range(1, 64)] == \
           [jconfig.words_per_kmer(k) for k in range(1, 64)]


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=64), dict(k=31, max_read_len=30), dict(mesh_shape=(0, 1)),
    dict(tau_parent=0xFFFF), dict(min_child_count=0), dict(extractor="cuda"),
    dict(accum_batches=0), dict(read_len_buckets=(64, 32)),
    dict(read_len_buckets=(64,)), dict(read_len_buckets=(16, 160)),
])
def test_engine_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jconfig.EngineConfig(**bad)
    with pytest.raises(ValueError):
        tconfig.EngineConfig(**bad)


def test_metrics_summary_matches_jax():
    ms = (Metrics(), JaxMetrics())
    for m in ms:
        m.count("kmers_extracted", 1000)
        m.count("batches", 3)
        m.add_seconds("extract_probe", 0.5)
    assert ms[0].summary() == ms[1].summary()
    assert ms[0].to_dict() == ms[1].to_dict()


def test_oracle_matches_jax():
    rng = np.random.default_rng(2)
    cfg = jconfig.EngineConfig(k=13, max_read_len=64, min_base_quality=20)
    reads = []
    for _ in range(40):
        L = int(rng.integers(5, 60))
        seq = "".join(rng.choice(list("ACGTNacgt"), L))
        qual = tuple(int(q) for q in rng.integers(0, 41, L))
        reads.append((seq, qual if rng.random() < 0.7 else None, int(rng.integers(0, 2)) * 0x400))
    tcfg = tconfig.EngineConfig(k=13, max_read_len=64, min_base_quality=20)
    assert toracle.count_reads(reads, tcfg) == joracle.count_reads(reads, cfg)
    t = joracle.count_reads(reads, cfg)
    cands = joracle.trio_candidates({}, {}, t, cfg)
    assert toracle.format_report(cands, 13) == joracle.format_report(cands, 13)
    assert toracle.format_fasta(cands, 13) == joracle.format_fasta(cands, 13)
    for v in list(t)[:20]:
        assert toracle.kmer_value_to_words(v, 13) == joracle.kmer_value_to_words(v, 13)
        assert toracle.decode_kmer(v, 13) == joracle.decode_kmer(v, 13)


def _records(rng, n):
    recs = []
    for i in range(n):
        L = int(rng.integers(0, 200))
        seq = "".join(rng.choice(list("ACGTN=MRacgtn"), L))
        qual = None if rng.random() < 0.3 else tuple(int(q) for q in rng.integers(0, 60, L))
        recs.append(tbam.BamRecord(name=f"r{i}", flag=int(rng.integers(0, 4096)), refid=0,
                                   pos=int(rng.integers(0, 10**6)), mapq=60,
                                   cigar=((max(L, 1), 0),), seq=seq, qual=qual))
    return recs


def test_bam_writer_and_reader_match_jax():
    rng = np.random.default_rng(8)
    recs = _records(rng, 300)
    refs = [("chr1", 10**6)]
    out = {}
    for name, mod in (("port", tbam), ("jax", jbam)):
        buf = io.BytesIO()
        with mod.BamWriter(buf, references=refs) as w:
            for r in recs:
                w.write(mod.BamRecord(**dataclasses.asdict(r)))
        out[name] = buf.getvalue()
    assert out["port"] == out["jax"]
    got = list(tbam.BamReader(io.BytesIO(out["port"])))
    want = list(jbam.BamReader(io.BytesIO(out["jax"])))
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    # lower-case and unknown characters read back as the reference reader gives them
    assert [r.seq for r in got] == [r.seq for r in want]


def test_bgzf_virtual_offsets_match_jax():
    payload = bytes(np.random.default_rng(1).integers(0, 4, 200_000, dtype=np.uint8))
    buf = io.BytesIO()
    with tbgzf.BgzfWriter(buf) as w:
        w.write(payload)
    raw = buf.getvalue()
    readers = (tbgzf.BgzfReader(io.BytesIO(raw)), jbgzf.BgzfReader(io.BytesIO(raw)))
    marks = []
    for n in (10, 70_000, 5, 65_280, 64_705):
        chunks = [r.read(n) for r in readers]
        assert chunks[0] == chunks[1]
        offs = [r.tell_virtual() for r in readers]
        assert offs[0] == offs[1]
        marks.append(offs[0])
    assert readers[0].read(10) == readers[1].read(10) == b""  # all 200,000 bytes read
    for mark in marks[:3]:
        for r in readers:
            r.seek_virtual(mark)
        assert readers[0].read(1000) == readers[1].read(1000)
    with pytest.raises(tbgzf.BgzfError):
        tbgzf.BgzfReader(io.BytesIO(raw[:100])).read(10)


def test_fasta_and_fastq_readers_match_jax(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(">a desc\nACGT\nNNAC\n\n>b\nTTTT\n>\nGG\n")
    assert list(read_fasta(str(fa))) == list(jax_read_fasta(str(fa)))
    fq = tmp_path / "x.fq"
    fq.write_text("@r1 x\nACGT\n+\nIIII\n\n@r2\nNNA\n+r2\n#5I\n")
    assert list(read_fastq(str(fq))) == list(jax_read_fastq(str(fq)))
    bad = tmp_path / "bad.fq"
    bad.write_text("@r1\nACGT\n+\nII\n")
    with pytest.raises(ValueError):
        list(read_fastq(str(bad)))


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch_batches(iter(range(50)), depth=2)) == list(range(50))

    def boom():
        yield 1
        raise KeyError("decode failed")

    with pytest.raises(KeyError):
        list(prefetch_batches(boom()))


def test_prefetch_stops_the_producer_on_early_exit():
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield i
            i += 1

    before = threading.active_count()
    gen = prefetch_batches(endless(), depth=2)
    assert next(gen) == 0
    gen.close()
    assert started.is_set()
    assert threading.active_count() == before


def test_prefetch_placed_on_cpu_ships_lengths_for_prefix_valid_batches():
    cfg = tconfig.EngineConfig(k=11, max_read_len=32, batch_reads=4, table_capacity=64)
    clean = pack_seqs(["ACGTACGTACGTA", "TTTTGGGGCCCCAAAA"], cfg, batch_size=4)
    with_n = pack_seqs(["ACGTNACGTACGTA"], cfg, batch_size=4)
    a, b = list(prefetch_placed(iter([clean, with_n]), "cpu", ship_lengths=True))
    assert isinstance(a, PackedReads) and isinstance(b, PackedReads)
    assert a.vwords is None and a.words.dtype == torch.int32
    np.testing.assert_array_equal(a.words.numpy().view(np.uint32), clean.words)
    np.testing.assert_array_equal(a.length.numpy(), clean.length)
    assert b.vwords is not None and isinstance(b.length, np.ndarray)
    np.testing.assert_array_equal(b.vwords.numpy().view(np.uint32), with_n.vwords)


def test_prefetch_placed_put_places_each_array_as_jax_does():
    """``put`` receives the same host arrays, in the same order, as the JAX package's; the
    placed batches carry what it returns."""
    from denovo_kmer_tpu.config import EngineConfig as JaxConfig
    from denovo_kmer_tpu.ops.pack import pack_seqs as jax_pack_seqs

    seqs = [["ACGTACGTACGTA", "TTTTGGGGCCCCAAAA"], ["ACGTNACGTACGTA"], ["GATTACA" * 3]]
    kw = dict(k=11, max_read_len=32, batch_reads=4, table_capacity=64)
    calls = {}
    for name, prefetch, pack, cfg in (
            ("jax", jax_prefetch_placed, jax_pack_seqs, JaxConfig(**kw)),
            ("port", prefetch_placed, pack_seqs, tconfig.EngineConfig(**kw))):
        seen = []

        def put(a, seen=seen):
            seen.append(np.array(a))
            return ("placed", len(seen))

        batches = [pack(s, cfg, batch_size=4) for s in seqs]
        out = list(prefetch(iter(batches), put=put, ship_lengths=True))
        # words then lengths (prefix-valid) or validity words (a batch with an N)
        assert [b.words for b in out] == [("placed", i) for i in (1, 3, 5)]
        assert out[0].vwords is None and out[1].vwords == ("placed", 4)
        calls[name] = seen
    assert len(calls["port"]) == len(calls["jax"]) == 6
    for a, b in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(a, b)


def test_prefetch_placed_defaults_to_the_card():
    cfg = tconfig.EngineConfig(k=11, max_read_len=32, batch_reads=4, table_capacity=64)
    batches = iter([pack_seqs(["ACGTACGTACGTA"], cfg, batch_size=4)])
    if torch.cuda.is_available():
        assert next(prefetch_placed(batches)).words.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            next(prefetch_placed(batches))


def test_stage_timer_laps_as_jax_does(monkeypatch):
    import types

    for mod in (jmetrics, tmetrics):
        clock = iter([10.0, 10.5, 12.0])
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda clock=clock: next(clock)))
    laps = []
    for timer in (jmetrics.StageTimer(), tmetrics.StageTimer()):
        laps.append((timer.lap(), timer.lap(), timer.t0))
    assert laps[0] == laps[1] == (0.5, 1.5, 12.0)
