"""ctypes wrapper for the port's C++ BAM feeder (``_native/bam_ingest.cpp``).

The BAM half of ``denovo_kmer_tpu/io/native.py``: the shared library is compiled on first use
(``g++ -O3 -march=native``, linked against libdeflate where it is installed, else zlib alone)
into ``_native/build/`` from the port's own copy of the source, and keyed to the source's
hash and the host's CPU flags. When no compiler can build it, ``native_available()`` is False
and callers take the pure-Python feeder, whose batches are identical
(tests/test_torch_native.py); ``native_build_error()`` says why. The decode worker threads
follow ``DENOVO_KMER_INGEST_THREADS`` (default 4, 0 = synchronous).
"""

from __future__ import annotations

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


def library_path() -> str:
    """The feeder library for this source and this host."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + _host_fingerprint().encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libbam_ingest-{digest}.so")


def _build(out: str) -> Optional[str]:
    """Compile the feeder into ``out`` (through a temporary name, so that a concurrent
    build never loads a half-written file); the error text, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    base = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
            SOURCE, "-o", tmp, "-lz"]
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
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built first where needed; None (and ``_build_error`` set) when it
    cannot be built or loaded — the caller falls back to the pure-Python feeder."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = library_path()
            if not os.path.exists(out):
                _build_error = _build(out)
                if _build_error is not None:
                    return None
            _lib = _bind(ctypes.CDLL(out))
        except (OSError, AttributeError) as e:
            # unreadable source, a corrupt cached library or one missing a symbol
            _build_error = f"native feeder unusable: {e}"
        return _lib


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
