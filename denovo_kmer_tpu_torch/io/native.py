"""ctypes wrapper for the port's native library: the C++ BAM feeder and the CRAM codecs.

A copy of ``denovo_kmer_tpu/io/native.py``. One shared library is compiled on first use
(``g++ -O3 -march=native``, linked against libdeflate where it is installed, else zlib alone)
into ``_native/build/`` from the port's own copies of ``bam_ingest.cpp`` (BAM decode+pack,
gzip/deflate one-shot inflate), ``rans_codec.cpp`` (rANS 4x8 and Nx16), ``cram_util.cpp``
(ITF8 varint runs) and ``arith_codec.cpp`` (adaptive arithmetic and fqzcomp). Its file name
is keyed to the hash of all four sources, the host's CPU flags and the sanitizer setting
(``DENOVO_KMER_SANITIZE=address[,undefined]`` builds an ASan/UBSan library), so an edit or a
new symbol rebuilds it. When no compiler can build it, ``native_available()`` is False:
callers take the pure-Python feeder and the codecs decode in Python, with identical output
(tests/test_torch_native.py, tests/test_torch_codecs.py); ``native_build_error()`` says why.
The decode worker threads follow ``DENOVO_KMER_INGEST_THREADS`` (default 4, 0 = synchronous).
"""

from __future__ import annotations

import _ctypes
import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.pack import PackedReads, padded_length

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "_native", "bam_ingest.cpp")
#: every source of the library, in the JAX package's link order
SOURCES = (SOURCE,) + tuple(os.path.join(_HERE, "_native", f) for f in
                            ("rans_codec.cpp", "cram_util.cpp", "arith_codec.cpp"))
BUILD_DIR = os.path.join(_HERE, "_native", "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _host_fingerprint() -> str:
    """CPU identity for the -march=native binary: a library built on another machine can
    carry ISA extensions this host lacks and would fault at call time, not load time."""
    probe = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    probe += line
                    break
    except OSError:
        pass
    return hashlib.sha256(probe.encode()).hexdigest()[:16]


def _sanitize() -> str:
    return os.environ.get("DENOVO_KMER_SANITIZE", "")


def library_path() -> str:
    """The library for these sources, this host and this sanitizer setting."""
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(_host_fingerprint().encode() + _sanitize().encode())
    return os.path.join(BUILD_DIR, f"libbam_ingest-{h.hexdigest()[:16]}.so")


def _build(out: str) -> Optional[str]:
    """Compile the library into ``out`` (through a temporary name, so that a concurrent
    build never loads a half-written file); the error text, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    san = _sanitize()
    san_flags = [f"-fsanitize={san}", "-fno-omit-frame-pointer", "-g"] if san else []
    base = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
            *san_flags, *SOURCES, "-o", tmp, "-lz"]
    # libdeflate inflates whole BGZF blocks 2-3x faster than zlib; zlib alone otherwise
    for cmd in (base + ["-DHAVE_LIBDEFLATE", "-ldeflate"], base):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"compiler unavailable: {e}"
        if proc.returncode == 0:
            os.replace(tmp, out)
            return None
    return f"build failed:\n{proc.stderr}"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bam_ingest_open.restype = ctypes.c_void_p
    lib.bam_ingest_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.bam_ingest_next_batch.restype = ctypes.c_int64
    lib.bam_ingest_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bam_ingest_tell_virtual.restype = ctypes.c_int64
    lib.bam_ingest_tell_virtual.argtypes = [ctypes.c_void_p]
    lib.bam_ingest_seek_virtual.restype = ctypes.c_int
    lib.bam_ingest_seek_virtual.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bam_ingest_error.restype = ctypes.c_char_p
    lib.bam_ingest_error.argtypes = [ctypes.c_void_p]
    lib.bam_ingest_close.restype = None
    lib.bam_ingest_close.argtypes = [ctypes.c_void_p]
    # rANS block decoders (rans_codec.cpp) — used by io/rans.py and io/rans_nx16.py
    for fn in (lib.dk_rans4x8_decode, lib.dk_rans_nx16_decode):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    # adaptive-arithmetic entropy decoder (arith_codec.cpp) — used by io/arith.py
    lib.dk_arith_entropy_decode.restype = ctypes.c_int
    lib.dk_arith_entropy_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    # gzip/deflate one-shot decompress (bam_ingest.cpp) — io/cram.py gzip blocks and
    # io/bgzf.py's pure-Python reader (remote BAM, BAI, .gz sidecars)
    for fn in (lib.dk_gzip_decompress, lib.dk_deflate_decompress):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    # fqzcomp record-loop decoder (arith_codec.cpp) — used by io/fqz.py
    lib.dk_fqz_decode.restype = ctypes.c_int
    lib.dk_fqz_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    # CRAM varint run decoder (cram_util.cpp) — used by io/cram.py _ByteStream
    lib.dk_itf8_decode_run.restype = ctypes.c_int64
    lib.dk_itf8_decode_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built first where needed; None (and ``_build_error`` set) when it
    cannot be built or loaded — the caller falls back to the pure-Python feeder and codecs.
    A cached library that will not load or lacks a symbol is rebuilt once."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = library_path()
            for attempt in (0, 1):
                if not os.path.exists(out):
                    _build_error = _build(out)
                    if _build_error is not None:
                        return None
                try:
                    lib = ctypes.CDLL(out)
                except OSError:
                    if attempt:
                        raise
                    os.remove(out)  # a corrupt cached library
                    continue
                try:
                    _lib = _bind(lib)
                    break
                except AttributeError:
                    # a library missing a symbol: unload it, or dlopen would hand the same
                    # stale image back for the rebuilt file at this path
                    _ctypes.dlclose(lib._handle)
                    if attempt:
                        raise
                    os.remove(out)
        except (OSError, AttributeError) as e:
            # unreadable sources, or a fresh build that still will not load
            _build_error = f"native library unusable: {e}"
        return _lib


def rans_decode_native(payload: bytes, out_len: int, nx16: bool) -> Optional[bytes]:
    """Native rANS decode (4x8 or Nx16); None when the shim is unavailable. Raises on
    malformed input (negative return code) — never silently degrades to garbage."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(out_len, np.uint8)
    fn = lib.dk_rans_nx16_decode if nx16 else lib.dk_rans4x8_decode
    rc = fn(payload, len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_len)
    if rc != 0:
        raise ValueError(
            f"native rANS{'Nx16' if nx16 else '4x8'} decode failed (code {rc}): "
            f"malformed block"
        )
    return out.tobytes()


def arith_entropy_decode_native(buf: bytes, pos: int, out_len: int,
                                order: bool, rle: bool) -> Optional[bytes]:
    """Native adaptive-arithmetic entropy decode (io/arith.py hot loop); None when
    the shim is unavailable. Raises ValueError on malformed input (negative return
    code) with the same messages as the Python reference — never degrades to
    garbage."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(out_len, np.uint8)
    rc = lib.dk_arith_entropy_decode(
        buf, len(buf), pos,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_len,
        1 if order else 0, 1 if rle else 0,
    )
    if rc == -3:
        raise ValueError("arith: RLE run overran output")
    if rc != 0:
        raise ValueError("range_coder: corrupt stream (frequency out of range)")
    return out.tobytes()


def gzip_decompress_native(data: bytes, raw_size: int) -> Optional[bytes]:
    """One-shot gzip-member decompress via libdeflate; None when the shim is
    unavailable OR the stream isn't a clean gzip member of the expected size
    (caller falls back to zlib, which also accepts zlib wrapping)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(raw_size, np.uint8)
    n = lib.dk_gzip_decompress(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw_size)
    if n != raw_size:
        return None
    return out.tobytes()


def deflate_decompress_native(data: bytes, raw_size: int) -> Optional[bytes]:
    """One-shot raw-DEFLATE decompress via libdeflate; None when the shim is
    unavailable or the stream doesn't inflate to exactly raw_size."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(raw_size, np.uint8)
    n = lib.dk_deflate_decompress(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw_size)
    if n != raw_size:
        return None
    return out.tobytes()


def fqz_decode_native(buf: bytes, pos: int, qmap: bytes,
                      geom, dedup: bool, ulen: int) -> Optional[bytes]:
    """Native fqzcomp record-loop decode (io/fqz.py); None when the shim is
    unavailable. Raises ValueError on malformed input with messages matching the
    Python reference's failure modes."""
    lib = _load()
    if lib is None:
        return None
    qbits, q2bits, pbits, dbits = geom
    out = np.empty(ulen, np.uint8)
    rc = lib.dk_fqz_decode(
        buf, len(buf), pos, qmap, len(qmap), qbits, q2bits, pbits, dbits,
        1 if dedup else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ulen,
    )
    if rc == -2:
        raise ValueError("fqz: stream exhausted before block was rebuilt")
    if rc == -3:
        raise ValueError("fqz: record overruns block")
    if rc != 0:
        raise ValueError("range_coder: corrupt stream (frequency out of range)")
    return out.tobytes()


def itf8_decode_run_native(buf: bytes, pos: int, max_n: int):
    """Decode up to ``max_n`` consecutive ITF8 varints starting at ``pos``.

    Returns ``(vals, ends)`` int64 arrays of the frames fully contained in the
    buffer (possibly fewer than max_n, possibly empty), or ``None`` when the
    shim is unavailable. Semantics mirror cram.itf8_decode frame-for-frame; a
    truncated trailing frame is simply not decoded.
    """
    lib = _load()
    if lib is None:
        return None
    vals = np.empty(max_n, np.int64)
    ends = np.empty(max_n, np.int64)
    n = lib.dk_itf8_decode_run(
        buf, len(buf), pos, max_n,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return vals[:n], ends[:n]


def native_available() -> bool:
    return _load() is not None


def native_build_error() -> Optional[str]:
    _load()
    return _build_error


def _popcount(a: np.ndarray) -> int:
    """Total set bits (numpy>=2 bitwise_count, with a LUT fallback)."""
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(a).sum())
    lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    return int(lut[a.view(np.uint8)].sum())


class NativeBamFeeder:
    """Streams PackedReads batches straight from a BAM file through the C++ feeder.
    ``NativeBamFeeder.batches`` counts the batches that every feeder of the process has
    returned, so that a caller can tell which decoder fed a run."""

    batches = 0

    def __init__(self, path: str, cfg: EngineConfig):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native ingest unavailable: {_build_error}")
        self._lib = lib
        self._cfg = cfg
        self._h = lib.bam_ingest_open(path.encode(), cfg.filter_flag_mask,
                                      cfg.min_base_quality, cfg.max_read_len)
        if not self._h:
            raise IOError(f"cannot open BAM: {path}")
        self._lp = padded_length(cfg.max_read_len)

    def next_batch(self) -> Optional[PackedReads]:
        B, lp = self._cfg.batch_reads, self._lp
        words = np.zeros((B, lp // 16), np.uint32)
        vwords = np.zeros((B, lp // 32), np.uint32)
        lengths = np.zeros(B, np.int32)
        n = self._lib.bam_ingest_next_batch(
            self._h, B,
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            vwords.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if n < 0:
            raise IOError(f"BAM ingest error: {self._lib.bam_ingest_error(self._h).decode()}")
        if n == 0:
            return None
        # validity never extends past the length prefix, so equal population counts mean
        # validity == prefix exactly (as ops/pack._pack_codes decides it)
        pv = _popcount(vwords) == int(lengths.sum())
        NativeBamFeeder.batches += 1
        return PackedReads(words=words, vwords=vwords, length=lengths, n_reads=int(n),
                           prefix_valid=pv)

    def __iter__(self) -> Iterator[PackedReads]:
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def tell_virtual(self) -> int:
        return int(self._lib.bam_ingest_tell_virtual(self._h))

    def seek_virtual(self, voffset: int) -> None:
        if self._lib.bam_ingest_seek_virtual(self._h, voffset) != 0:
            raise IOError(f"seek_virtual({voffset:#x}) failed")

    def close(self) -> None:
        if self._h:
            self._lib.bam_ingest_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
