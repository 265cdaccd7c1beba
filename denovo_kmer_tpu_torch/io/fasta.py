"""FASTA/FASTQ readers (plain or gzip). A copy of ``read_fasta`` and ``read_fastq`` from
``denovo_kmer_tpu/io/fasta.py``; faidx comes with a later slice."""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional, Tuple


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
