"""FASTA/FASTQ readers (plain or gzip) + faidx (.fai) indexed random access.

A copy of ``denovo_kmer_tpu/io/fasta.py``. A 5-column ``.fai`` sidecar (name, length, byte
offset of first base, bases per line, bytes per line) gives O(1) access to any contig or
sub-range without loading the whole genome. ``build_fai``/``read_fai`` implement that
format; ``FaidxFasta`` is the lazy mapping the CRAM reader consumes in place of an eager
dict."""

from __future__ import annotations

import dataclasses
import gzip
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) pairs."""
    name: Optional[str] = None
    seq: List[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(seq)
                fields = line[1:].split()
                name = fields[0] if fields else ""  # bare '>' header: unnamed record
                seq = []
            else:
                seq.append(line)
        if name is not None:
            yield name, "".join(seq)


# ---------------------------------------------------------------------------
# faidx: .fai index build/read + lazy indexed access
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaiEntry:
    """One .fai line: contig length in bases, byte offset of the first base,
    bases per full sequence line, bytes per full sequence line (incl. newline)."""
    length: int
    offset: int
    linebases: int
    linewidth: int


def _is_gz(path: str) -> bool:
    return path.endswith((".gz", ".bgz"))


def build_fai(fasta_path: str, fai_path: Optional[str] = None) -> str:
    """Scan a plain (uncompressed) FASTA once and write ``<path>.fai``.

    Matches samtools faidx semantics: every sequence line of a record except the
    last must have the same length; a longer/irregular mid-record line or a blank
    line inside a record is an error (random access would be ill-defined). Returns
    the index path.

    ``.gz`` input must be BGZF (bgzip): offsets are into the uncompressed stream
    and a ``.gzi`` block index is written alongside, like ``samtools faidx`` on a
    bgzipped reference. Plain gzip is rejected — no random access exists."""
    if _is_gz(fasta_path):
        from denovo_kmer_tpu_torch.io.bgzf import build_gzi, is_bgzf

        if not is_bgzf(fasta_path):
            raise ValueError(
                f"cannot faidx-index plain-gzip FASTA {fasta_path!r}: no random "
                f"access into a raw .gz stream; recompress with bgzip, decompress, "
                f"or load eagerly with load_reference()"
            )
        build_gzi(fasta_path)
        lines_cm = None
        lines = _bgzf_lines(fasta_path)
    else:
        lines_cm = open(fasta_path, "rb")
        lines = lines_cm
    fai_path = fai_path or fasta_path + ".fai"
    entries: List[Tuple[str, FaiEntry]] = []
    try:
        name: Optional[str] = None
        offset = 0          # byte offset of the current record's first base
        length = 0          # bases seen so far in the current record
        linebases = 0       # bases on the first (full) line
        linewidth = 0       # bytes on the first (full) line incl. newline
        # previous line's (bases, raw bytes); None = no line yet, -1 = blank seen
        last_len = None
        pos = 0
        for raw in lines:
            line_start = pos
            pos += len(raw)
            stripped = raw.rstrip(b"\r\n")
            if stripped.startswith(b">"):
                if name is not None:
                    entries.append((name, FaiEntry(length, offset, linebases, linewidth)))
                fields = stripped[1:].split()
                name = fields[0].decode() if fields else ""
                offset = pos
                length = 0
                linebases = 0
                linewidth = 0
                last_len = None
                continue
            if name is None:
                if not stripped:
                    continue  # leading blank lines before the first header
                raise ValueError(f"{fasta_path}: sequence data before first '>' header")
            if not stripped:
                # a blank line terminates the record body; any sequence after it
                # (without a new header) would be unreachable by offset arithmetic
                last_len = -1
                continue
            if last_len == -1:
                raise ValueError(
                    f"{fasta_path}: sequence after a blank line in record {name!r} "
                    f"(byte {line_start}); faidx requires contiguous sequence lines"
                )
            if last_len is not None and last_len != (linebases, linewidth):
                # the previous line was short or had a different terminator —
                # allowed only as the FINAL line of the record, and another
                # sequence line just followed it
                raise ValueError(
                    f"{fasta_path}: irregular sequence line length in record "
                    f"{name!r} (byte {line_start})"
                )
            if linebases == 0:
                linebases = len(stripped)
                linewidth = len(raw)
            elif len(stripped) > linebases:
                raise ValueError(
                    f"{fasta_path}: irregular sequence line length in record "
                    f"{name!r} (byte {line_start})"
                )
            last_len = (len(stripped), len(raw))
            length += len(stripped)
        if name is not None:
            entries.append((name, FaiEntry(length, offset, linebases, linewidth)))
    finally:
        if lines_cm is not None:
            lines_cm.close()
    seen = set()
    for n, _ in entries:
        if n in seen:
            raise ValueError(f"{fasta_path}: duplicate sequence name {n!r}")
        seen.add(n)
    # atomic publish: concurrent starters race benignly (last replace wins,
    # readers never see a torn index)
    tmp = fai_path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as out:
        for n, e in entries:
            out.write(f"{n}\t{e.length}\t{e.offset}\t{e.linebases}\t{e.linewidth}\n")
    os.replace(tmp, fai_path)
    return fai_path


def _bgzf_lines(path: str) -> Iterator[bytes]:
    """Lines (terminators kept) of a BGZF file's uncompressed stream."""
    from denovo_kmer_tpu_torch.io.bgzf import BgzfReader

    with open(path, "rb") as f:
        r = BgzfReader(f)
        rem = b""
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                if rem:
                    yield rem
                return
            rem += chunk
            parts = rem.split(b"\n")
            rem = parts.pop()
            for ln in parts:
                yield ln + b"\n"


def read_fai(fai_path: str) -> Dict[str, FaiEntry]:
    """Parse a .fai file (local path or URL) → ordered {name: FaiEntry}."""
    out: Dict[str, FaiEntry] = {}
    from denovo_kmer_tpu_torch.io.remote import open_binary

    with open_binary(fai_path) as f:
        lines = f.read(1 << 30).decode().splitlines()
    for lineno, line in enumerate(lines, 1):
        if not line:
            continue
        cols = line.split("\t")
        if len(cols) < 5:
            raise ValueError(f"{fai_path}:{lineno}: expected 5 tab-separated columns")
        name = cols[0]
        try:
            length, offset, linebases, linewidth = (int(c) for c in cols[1:5])
        except ValueError:
            raise ValueError(f"{fai_path}:{lineno}: non-integer index column") from None
        out[name] = FaiEntry(length, offset, linebases, linewidth)
    return out


class FaidxFasta:
    """Lazy, .fai-indexed FASTA access with the mapping surface the CRAM reader
    uses (``get``/``[]``/``in``): contigs are read from disk on first use and a
    few whole contigs are kept in an LRU cache (CRAM decode touches slices of one
    chromosome at a time). ``fetch(name, start, end)`` reads just a 0-based
    half-open sub-range without materializing the contig."""

    _CACHE_SLOTS = 4

    def __init__(self, fasta_path: str, fai_path: Optional[str] = None):
        fai_path = fai_path or fasta_path + ".fai"
        remote = "://" in fasta_path
        if not remote and not os.path.exists(fai_path):
            build_fai(fasta_path, fai_path)
        self.path = fasta_path
        # hosted references (htslib's remote faidx): the .fai (and .gzi for
        # bgzipped FASTA) must be served alongside — indexing a remote file
        # would mean downloading all of it, which defeats the point
        self.index = read_fai(fai_path)
        from denovo_kmer_tpu_torch.io.remote import open_binary

        self._f = open_binary(fasta_path)
        self._bgzf = None
        self._gzi = None
        if _is_gz(fasta_path):
            from denovo_kmer_tpu_torch.io.bgzf import BgzfReader, GziIndex, build_gzi

            gzi_path = fasta_path + ".gzi"
            if not remote and not os.path.exists(gzi_path):
                build_gzi(fasta_path)  # .fai pre-existed but .gzi didn't
            self._gzi = GziIndex.load(gzi_path)
            self._bgzf = BgzfReader(self._f)
        self._cache: Dict[str, str] = {}
        self._validated: set = set()
        # the CRAM container pool resolves references from worker threads;
        # seek+read on the shared handle must be atomic
        self._lock = threading.Lock()

    # -- mapping surface ----------------------------------------------------
    def get(self, name, default=None):
        if not isinstance(name, str) or name not in self.index:
            return default
        return self[name]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name in self.index

    def __getitem__(self, name: str) -> str:
        cached = self._cache.pop(name, None)
        if cached is None:
            e = self.index[name]  # KeyError propagates
            cached = self.fetch(name, 0, e.length)
            while len(self._cache) >= self._CACHE_SLOTS:
                self._cache.pop(next(iter(self._cache)))
        self._cache[name] = cached  # re-insert = move to MRU position
        return cached

    def keys(self):
        return self.index.keys()

    def lengths(self) -> Dict[str, int]:
        return {n: e.length for n, e in self.index.items()}

    # -- ranged access ------------------------------------------------------
    def _pread(self, offset: int, n: int) -> bytes:
        """n uncompressed bytes at ``offset`` (thread-safe; GZI-routed for BGZF)."""
        with self._lock:
            if self._bgzf is not None:
                # offsets are into the uncompressed stream; the GZI index turns
                # them into block-addressed virtual offsets (with a block-length
                # cross-check against the file)
                self._gzi.seek(self._bgzf, offset)
                return self._bgzf.read(n)
            self._f.seek(offset)
            return self._f.read(n)

    def _validate_entry(self, name: str) -> None:
        """First-use check of an entry against the file itself: the bytes
        immediately before ``offset`` must be the record's own ``>name`` header
        line. Neither .fai nor .gzi carries a checksum, so this is what catches
        a corrupted/stale index before it silently returns shifted sequence."""
        if name in self._validated:
            return
        e = self.index[name]
        back = min(e.offset, 65536)
        raw = self._pread(e.offset - back, back)
        if back == 65536 and not raw.startswith(b">") and b"\n>" not in raw:
            # the whole window is sequence/description with no header start in
            # sight (>64 KiB header lines are legal) — cannot validate cheaply;
            # never reject a valid file for it
            self._validated.add(name)
            return
        lines = raw.split(b"\n")
        ok = (back > 0 and lines[-1] == b"" and len(lines) >= 2)
        if ok:
            hdr = lines[-2].rstrip(b"\r")
            fields = hdr[1:].split()
            token = fields[0].decode("ascii", "replace") if fields else ""
            ok = hdr.startswith(b">") and token == name
        if not ok:
            raise ValueError(
                f"{self.path}: .fai entry for {name!r} does not line up with the "
                f"file (offset {e.offset} is not preceded by its header line) — "
                f"stale or corrupt index; delete the .fai to rebuild"
            )
        self._validated.add(name)

    def fetch(self, name: str, start: int, end: Optional[int] = None) -> str:
        """Bases ``[start, end)`` (0-based half-open; ``end=None`` → contig end).
        Out-of-range coordinates clamp to the contig, like htslib's faidx_fetch_seq."""
        e = self.index[name]
        self._validate_entry(name)
        if end is None or end > e.length:
            end = e.length
        start = max(start, 0)
        if start >= end:
            return ""
        first = e.offset + (start // e.linebases) * e.linewidth + (start % e.linebases)
        last = e.offset + ((end - 1) // e.linebases) * e.linewidth + ((end - 1) % e.linebases)
        raw = self._pread(first, last + 1 - first)
        out = raw.translate(None, b"\r\n").decode("ascii")
        if len(out) != end - start:
            # wrong linebases/linewidth (or truncated file) shifts the newline
            # density inside the span — never hand back silently wrong bases
            raise ValueError(
                f"{self.path}: faidx fetch of {name}:{start}-{end} produced "
                f"{len(out)} bases (expected {end - start}) — stale or corrupt "
                f".fai; delete it to rebuild"
            )
        return out

    def close(self):
        self._f.close()

    def __del__(self):  # feeders drop instances without close(); free the fd
        try:
            self._f.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_reference_indexed(fasta_path: str):
    """Reference mapping for CramReader: faidx-lazy for plain or bgzipped local
    FASTA (building the .fai/.gzi on first use), eager dict for plain gzip.

    Falls back to the eager loader whenever lazy indexing is impossible —
    read-only reference directory (cannot write the .fai), irregular line
    layout — so production pipelines never regress on inputs the eager path
    accepted (pipeline.py feeders call this)."""
    if _is_gz(fasta_path):
        from denovo_kmer_tpu_torch.io.bgzf import is_bgzf

        if not is_bgzf(fasta_path):
            from denovo_kmer_tpu_torch.io.cram import load_reference
            return load_reference(fasta_path)
    try:
        return FaidxFasta(fasta_path)
    except (OSError, ValueError):
        from denovo_kmer_tpu_torch.io.cram import load_reference
        return load_reference(fasta_path)


def read_fastq(path: str) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """Yield (name, sequence, phred_qualities). Malformed records (non-'@' header,
    truncated 4-line group, seq/qual length mismatch) raise ValueError; blank trailing
    lines are tolerated."""
    with _open_text(path) as f:
        lineno = 0
        while True:
            hdr = f.readline()
            lineno += 1
            if not hdr:
                return
            if not hdr.strip():
                continue  # blank line (e.g. trailing newline at EOF)
            if not hdr.startswith("@"):
                raise ValueError(f"{path}:{lineno}: FASTQ header must start with '@'")
            seq = f.readline().strip()
            plus = f.readline()
            qual = f.readline().strip()
            lineno += 3
            if not plus.startswith("+"):
                raise ValueError(f"{path}:{lineno - 1}: truncated FASTQ record")
            if len(qual) != len(seq):
                raise ValueError(
                    f"{path}:{lineno}: quality length {len(qual)} != sequence "
                    f"length {len(seq)}"
                )
            fields = hdr.strip()[1:].split()
            name = fields[0] if fields else ""
            yield name, seq, tuple(ord(c) - 33 for c in qual)
