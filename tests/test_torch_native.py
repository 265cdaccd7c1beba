"""The port's C++ BAM feeder (denovo_kmer_tpu_torch/io/native.py, built from the port's own
io/_native/bam_ingest.cpp) against the JAX package's NativeBamFeeder and the port's Python
packer, at tests/test_native_ingest.py's cases: words, vwords, lengths, n_reads and
prefix_valid bit for bit, with and without a base-quality floor, truncation, the virtual
seek; the pipeline's feeder dispatch and its clean fallback. Tolerance 0."""

import os

import numpy as np
import pytest

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.io.native import NativeBamFeeder as JaxFeeder
from denovo_kmer_tpu.io.native import native_available as jax_native_available
from denovo_kmer_tpu_torch import pipeline
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io import native
from denovo_kmer_tpu_torch.io.bam import read_bam_records
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.ops.pack import pack_records

# the fixture of tests/test_native_ingest.py
SPEC = TrioSpec(genome_len=2000, read_len=80, coverage=6.0, seed=21, n_rate=0.01)
FIELDS = ("words", "vwords", "length")


@pytest.fixture(scope="module")
def bam_path(tmp_path_factory):
    if not native.native_available():
        pytest.fail(f"the port's native feeder did not build: {native.native_build_error()}")
    d = tmp_path_factory.mktemp("native")
    return write_trio_bams(make_trio(SPEC), str(d))["child"]


def _same(a, b):
    assert a.n_reads == b.n_reads
    assert bool(a.prefix_valid) == bool(b.prefix_valid)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _native_batches(path, cfg):
    with native.NativeBamFeeder(path, cfg) as feeder:
        return list(feeder)


@pytest.mark.parametrize("minq", [0, 25])
def test_native_matches_python_packer_and_jax_feeder(bam_path, minq):
    kw = dict(k=21, max_read_len=96, batch_reads=64, min_base_quality=minq)
    got = _native_batches(bam_path, EngineConfig(**kw))
    py = list(pack_records(read_bam_records(bam_path), EngineConfig(**kw)))
    assert len(got) == len(py) > 1
    for g, p in zip(got, py):
        _same(g, p)
    if not jax_native_available():
        pytest.skip("the JAX package's native feeder did not build here")
    with JaxFeeder(bam_path, JaxConfig(**kw)) as feeder:
        want = list(feeder)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        _same(g, w)


def test_native_truncates_long_reads(bam_path):
    # max_read_len shorter than the read length: both feeders truncate identically
    cfg = EngineConfig(k=21, max_read_len=64, batch_reads=64)
    got = _native_batches(bam_path, cfg)
    py = list(pack_records(read_bam_records(bam_path), cfg))
    assert len(got) == len(py)
    for g, p in zip(got, py):
        _same(g, p)


def test_native_virtual_seek(bam_path):
    cfg = EngineConfig(k=21, max_read_len=96, batch_reads=32)
    with native.NativeBamFeeder(bam_path, cfg) as feeder:
        feeder.next_batch()
        v = feeder.tell_virtual()
        second = feeder.next_batch()
        feeder.seek_virtual(v)
        again = feeder.next_batch()
    _same(second, again)
    if jax_native_available():
        with JaxFeeder(bam_path, JaxConfig(k=21, max_read_len=96, batch_reads=32)) as jf:
            jf.next_batch()
            assert jf.tell_virtual() == v


@pytest.mark.parametrize("threads", ["0", "1", "4"])
def test_ingest_threads_do_not_change_batches(bam_path, monkeypatch, threads):
    """DENOVO_KMER_INGEST_THREADS (the CLI's --ingest-threads): synchronous inflate and the
    worker ring give the same batches."""
    cfg = EngineConfig(k=21, max_read_len=96, batch_reads=64)
    want = list(pack_records(read_bam_records(bam_path), cfg))
    monkeypatch.setenv("DENOVO_KMER_INGEST_THREADS", threads)
    got = _native_batches(bam_path, cfg)
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got) == len(want)


def test_packed_batches_takes_the_native_feeder_for_a_bam(bam_path, monkeypatch):
    cfg = EngineConfig(k=21, max_read_len=96, batch_reads=64, min_base_quality=20)
    opened = []
    real = native.NativeBamFeeder

    class Spy(real):
        def __init__(self, path, c):
            opened.append(path)
            super().__init__(path, c)

    monkeypatch.setattr(native, "NativeBamFeeder", Spy)
    got = list(pipeline.packed_batches(bam_path, cfg))
    assert opened == [bam_path]
    want = list(pack_records(read_bam_records(bam_path), cfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    # a record iterable (and a region) never take it
    list(pipeline.packed_batches(read_bam_records(bam_path), cfg))
    assert opened == [bam_path]


def test_failed_build_falls_back_to_python(bam_path, monkeypatch):
    """No compiler: native_available() is False, the build error is kept, and the
    pipeline's feeder and cursor stream fall back to the Python reader."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: os.path.join(native.BUILD_DIR, "absent-for-the-test.so"))
    monkeypatch.setattr(native, "_build", lambda out: "compiler unavailable: no g++")
    assert not native.native_available()
    assert "no g++" in native.native_build_error()
    cfg = EngineConfig(k=21, max_read_len=96, batch_reads=64)
    got = list(pipeline.packed_batches(bam_path, cfg))
    want = list(pack_records(read_bam_records(bam_path), cfg))
    for g, w in zip(got, want):
        _same(g, w)
    assert isinstance(pipeline.packed_stream_with_cursor(bam_path, cfg),
                      pipeline._PythonCursorStream)


def test_library_is_built_from_the_port_sources():
    assert native.native_available()
    port_native = os.path.join(os.path.dirname(native.__file__), "_native")
    assert native.SOURCE == os.path.join(port_native, "bam_ingest.cpp")
    assert os.path.dirname(native.library_path()) == os.path.join(port_native, "build")
    assert os.path.exists(native.library_path())
