"""Pure-Python scalar oracle for the pinned semantics (SPEC_SEMANTICS.md).

A copy of ``denovo_kmer_tpu/oracle/scalar.py``. Deliberately simple: Python ints (arbitrary
precision), dicts, no numpy in the hot path — the ground truth the device path must match
exactly (candidate k-mer sets and counts).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from denovo_kmer_tpu_torch.config import EngineConfig, words_per_kmer

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}
_BASE = "ACGT"


def encode_base(ch: str) -> int:
    """2-bit code for a base, or -1 if invalid (SPEC_SEMANTICS §1)."""
    return _CODE.get(ch, -1)


def encode_kmer(s: str) -> int:
    """Forward value of a k-mer string (SPEC_SEMANTICS §2). Raises on invalid bases."""
    v = 0
    for ch in s:
        c = _CODE.get(ch)
        if c is None:
            raise ValueError(f"invalid base {ch!r} in k-mer {s!r}")
        v = (v << 2) | c
    return v


def decode_kmer(v: int, k: int) -> str:
    """Inverse of :func:`encode_kmer`."""
    return "".join(_BASE[(v >> (2 * (k - 1 - j))) & 3] for j in range(k))


def revcomp_value(v: int, k: int) -> int:
    """Reverse-complement of a 2k-bit forward value."""
    r = 0
    for _ in range(k):
        r = (r << 2) | ((v & 3) ^ 3)
        v >>= 2
    return r


def canonical_value(v: int, k: int) -> int:
    """min(fwd, revcomp) as integers (SPEC_SEMANTICS §2)."""
    return min(v, revcomp_value(v, k))


def kmer_value_to_words(v: int, k: int) -> Tuple[int, ...]:
    """Big-endian uint32 word layout of a k-mer value (SPEC_SEMANTICS §2.1)."""
    w = words_per_kmer(k)
    return tuple((v >> (32 * (w - 1 - i))) & 0xFFFFFFFF for i in range(w))


def words_to_kmer_value(words: Sequence[int]) -> int:
    v = 0
    for word in words:
        v = (v << 32) | (int(word) & 0xFFFFFFFF)
    return v


def read_kmers(
    seq: str,
    cfg: EngineConfig,
    qual: Optional[Sequence[int]] = None,
) -> List[int]:
    """All emitted (canonical) k-mer values of one read, in window order (SPEC_SEMANTICS §3-4).

    ``qual`` is the per-base Phred quality (None = no quality filtering for this read).
    """
    k = cfg.k
    out: List[int] = []
    n = len(seq)
    codes = [encode_base(ch) for ch in seq]
    if qual is not None and cfg.min_base_quality > 0:
        if len(qual) < n:
            # zip() would silently truncate and fabricate short windows — a malformed
            # record must be an error, matching the device feeder's contract
            raise ValueError(
                f"quality string shorter than sequence ({len(qual)} < {n})"
            )
        codes = [
            c if (c >= 0 and q >= cfg.min_base_quality) else -1
            for c, q in zip(codes, qual)
        ]
    for i in range(n - k + 1):
        window = codes[i : i + k]
        if any(c < 0 for c in window):
            continue
        v = 0
        for c in window:
            v = (v << 2) | c
        out.append(canonical_value(v, k) if cfg.canonical else v)
    return out


def count_reads(
    reads: Iterable[Tuple[str, Optional[Sequence[int]], int]],
    cfg: EngineConfig,
) -> Dict[int, int]:
    """Build a k-mer table from (seq, qual, flag) records, applying the record filter.

    Returns {canonical k-mer value: count}.
    """
    table: Dict[int, int] = {}
    for seq, qual, flag in reads:
        if flag & cfg.filter_flag_mask:
            continue
        for v in read_kmers(seq, cfg, qual):
            table[v] = table.get(v, 0) + 1
    return table


def trio_candidates(
    mom: Dict[int, int],
    dad: Dict[int, int],
    child: Dict[int, int],
    cfg: EngineConfig,
) -> List[Tuple[int, int, int, int]]:
    """De novo candidates (SPEC_SEMANTICS §6), sorted ascending by k-mer value.

    Returns [(kmer_value, child_count, mom_count, dad_count), ...].
    """
    out = []
    for v, c in child.items():
        if c < cfg.min_child_count:
            continue
        m = mom.get(v, 0)
        d = dad.get(v, 0)
        if m <= cfg.tau_parent and d <= cfg.tau_parent:
            out.append((v, c, m, d))
    out.sort()
    return out


def format_report(
    candidates: List[Tuple[int, int, int, int]], k: int
) -> str:
    """Byte-exact TSV parity artifact (SPEC_SEMANTICS §7)."""
    lines = ["#kmer\tchild_count\tmom_count\tdad_count"]
    for v, c, m, d in candidates:
        lines.append(f"{decode_kmer(v, k)}\t{c}\t{m}\t{d}")
    return "\n".join(lines) + "\n"


def format_fasta(candidates: List[Tuple[int, int, int, int]], k: int) -> str:
    """Candidate k-mers as FASTA, counts in the headers — secondary reporter format (TSV
    stays the parity artifact)."""
    lines = []
    for i, (v, c, m, d) in enumerate(candidates):
        lines.append(f">denovo_{i} child={c} mom={m} dad={d}")
        lines.append(decode_kmer(v, k))
    return "\n".join(lines) + ("\n" if lines else "")
