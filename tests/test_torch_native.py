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


def test_library_is_keyed_on_every_source(tmp_path, monkeypatch):
    """The library's file name hashes all four sources (and the sanitizer setting): an
    edit to any one of them names a new library, so a stale build is never loaded."""
    copies = []
    for src in native.SOURCES:
        dst = tmp_path / os.path.basename(src)
        with open(src, "rb") as f:
            dst.write_bytes(f.read())
        copies.append(str(dst))
    monkeypatch.setattr(native, "SOURCES", tuple(copies))
    names = {native.library_path()}
    for c in copies:
        with open(c, "a") as f:
            f.write("\n// edited\n")
        names.add(native.library_path())
    monkeypatch.setenv("DENOVO_KMER_SANITIZE", "address")
    names.add(native.library_path())
    assert len(names) == len(copies) + 2


@pytest.mark.parametrize("stale", ["corrupt", "missing_symbols"])
def test_stale_cached_library_is_rebuilt(tmp_path, monkeypatch, stale):
    """A cached library that will not load (a truncated file) or lacks a symbol (here one
    exporting none of the library's) is removed and rebuilt once, not raised as an
    AttributeError."""
    import shutil
    import subprocess

    assert native.native_available()
    good = native.library_path()
    cached = tmp_path / "libbam_ingest-stale.so"
    if stale == "corrupt":
        cached.write_bytes(b"\x7fELF truncated")
    else:
        if shutil.which("g++") is None:
            pytest.skip("no g++")
        (tmp_path / "other.cpp").write_text('extern "C" int other_symbol() { return 1; }\n')
        r = subprocess.run(["g++", "-shared", "-fPIC", str(tmp_path / "other.cpp"), "-o",
                            str(cached)], capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
    builds = []

    def fake_build(out):
        builds.append(out)
        shutil.copyfile(good, out)
        return None

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "library_path", lambda: str(cached))
    monkeypatch.setattr(native, "_build", fake_build)
    assert native.native_available(), native.native_build_error()
    assert builds == [str(cached)]
    data = b"ACGT" * 100
    from denovo_kmer_tpu_torch.io import rans

    assert native.rans_decode_native(rans.encode(data, 0), len(data), nx16=False) == data


_FUZZ_MAIN = r'''
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" {
void* bam_ingest_open(const char*, int, int, int);
int64_t bam_ingest_next_batch(void*, int64_t, uint32_t*, uint32_t*, int32_t*);
void bam_ingest_close(void*);
int dk_rans4x8_decode(const uint8_t*, int64_t, uint8_t*, int64_t);
int dk_rans_nx16_decode(const uint8_t*, int64_t, uint8_t*, int64_t);
int dk_arith_entropy_decode(const uint8_t*, int64_t, int64_t, uint8_t*, int64_t, int, int);
int64_t dk_itf8_decode_run(const uint8_t*, int64_t, int64_t, int64_t, int64_t*, int64_t*);
int64_t dk_gzip_decompress(const uint8_t*, int64_t, uint8_t*, int64_t);
}
static std::vector<uint8_t> slurp(const char* p) {
  std::vector<uint8_t> b; FILE* f = fopen(p, "rb"); if (!f) exit(2);
  uint8_t t[4096]; size_t n; while ((n = fread(t, 1, sizeof t, f)) > 0) b.insert(b.end(), t, t + n);
  fclose(f); return b;
}
int main(int argc, char** argv) {
  // argv: <bam> <rans4x8> <nx16> <arith o1 rle> <gzip> <raw_len> <arith_pos> <libdeflate>
  void* h = bam_ingest_open(argv[1], 0xF04, 0, 96);
  if (!h) return 3;
  std::vector<uint32_t> w(64 * 96 / 16), v(64 * 96 / 32); std::vector<int32_t> l(64);
  int64_t n, total = 0;
  while ((n = bam_ingest_next_batch(h, 64, w.data(), v.data(), l.data())) > 0) total += n;
  bam_ingest_close(h);
  if (n < 0 || total == 0) return 4;
  int64_t raw = atoll(argv[6]), apos = atoll(argv[7]);
  int64_t gz_ok = atoi(argv[8]) ? raw : -1;  // without libdeflate the gzip entry declines
  std::vector<uint8_t> out(raw);
  const char* files[4] = {argv[2], argv[3], argv[4], argv[5]};
  unsigned seed = 777;
  for (int c = 0; c < 4; c++) {
    std::vector<uint8_t> buf = slurp(files[c]);
    for (int i = 0; i <= 200; i++) {
      std::vector<uint8_t> m = buf;
      size_t len = m.size();
      if (i) {  // i == 0 is the valid stream; then mutations and truncations
        seed = seed * 1103515245 + 12345; m[seed % m.size()] ^= (uint8_t)(1 + seed % 255);
        len = m.size() * (i % 7 + 1) / 8;
      }
      int64_t rc = c == 0 ? dk_rans4x8_decode(m.data(), len, out.data(), raw)
                 : c == 1 ? dk_rans_nx16_decode(m.data(), len, out.data(), raw)
                 : c == 2 ? dk_arith_entropy_decode(m.data(), len, apos, out.data(), raw, 1, 1)
                 : dk_gzip_decompress(m.data(), len, out.data(), raw);
      if (i == 0 && rc != (c == 3 ? gz_ok : 0)) return 10 + c;
    }
  }
  std::vector<int64_t> vals(64), ends(64);
  std::vector<uint8_t> itf = slurp(argv[2]);
  dk_itf8_decode_run(itf.data(), itf.size(), 0, 64, vals.data(), ends.data());
  printf("fuzz ok %lld\n", (long long)total);
  return 0;
}
'''


@pytest.mark.slow
def test_native_library_clean_under_asan_ubsan(bam_path, tmp_path):
    """The four sources of the port's library built with ASan/UBSan beside a driver that
    feeds a BAM through the feeder and valid, mutated and truncated rANS 4x8, rANS Nx16,
    arith and gzip streams through the decoders: the valid ones decode, and nothing trips
    a sanitizer (as tests/test_native_sanitize.py holds the JAX package's sources)."""
    import gzip
    import shutil
    import subprocess

    from denovo_kmer_tpu_torch.io import arith, rans, rans_nx16
    from denovo_kmer_tpu_torch.io.rans_nx16 import uint7_decode

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    main = tmp_path / "fuzz.cpp"
    main.write_text(_FUZZ_MAIN)
    exe = str(tmp_path / "fuzz")
    base = ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
            "-fno-omit-frame-pointer", "-pthread", str(main), *native.SOURCES, "-o", exe, "-lz"]
    for deflate, cmd in ((1, base + ["-DHAVE_LIBDEFLATE", "-ldeflate"]), (0, base)):
        build = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if build.returncode == 0:
            break
    assert build.returncode == 0, build.stderr
    data = bytes(np.random.default_rng(5).choice([30, 35, 40, 2], p=[.5, .3, .15, .05],
                                                 size=20000).astype(np.uint8))
    enc_arith = arith.encode(data, order=1, use_rle=True)
    _ulen, apos = uint7_decode(enc_arith, 1)
    files = []
    for name, blob in (("r4x8", rans.encode(data, order=1)),
                       ("nx16", rans_nx16.encode(data, order=1, use_pack=True, use_rle=True)),
                       ("arith", enc_arith), ("gz", gzip.compress(data))):
        (tmp_path / name).write_bytes(blob)
        files.append(str(tmp_path / name))
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=1:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1")
    run = subprocess.run([exe, bam_path, *files, str(len(data)), str(apos), str(deflate)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"stdout:{run.stdout}\nstderr:{run.stderr[-3000:]}"
    assert "fuzz ok" in run.stdout
    assert "AddressSanitizer" not in run.stderr and "runtime error" not in run.stderr
