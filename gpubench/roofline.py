"""The card's peaks, and the work the measured steps need, reckoned from their shapes.

The integer rate is ``INT_RESULTS_PER_CLOCK_SM`` results a clock on each SM at the card's
highest SM clock; bytes move at ``HBM_BYTES_PER_S``. A step's bound is the larger of its
bytes over the memory rate and its operations over the integer rate.
"""

from __future__ import annotations

import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# 32-bit integer add, compare and min/max results a clock an SM at compute capability 9.0
# (CUDA C++ Programming Guide, throughput of native arithmetic instructions)
INT_RESULTS_PER_CLOCK_SM = 64


def nvidia_smi(query: str) -> Optional[str]:
    """A ``nvidia-smi --query-gpu`` reading of card 0, or None where it cannot be read."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else None


def int_ops_per_s(sms: int) -> Optional[float]:
    """The card's integer rate, or None where its highest SM clock cannot be read."""
    clock = nvidia_smi("clocks.max.sm")
    if clock is None:
        return None
    return INT_RESULTS_PER_CLOCK_SM * sms * float(clock.split()[0]) * 1e6


def extraction_bytes_ops(B: int, Lw: int, k: int, max_len: int, canonical: bool,
                         with_vwords: bool) -> tuple:
    """(bytes, integer operations) of extracting a packed batch of B reads of ``Lw`` words
    into staged rows: the packed words and the validity words (or the lengths) read once,
    B·P rows of 4W+1 B written once; per window the two-word assembly of the forward and
    reverse-complement values, the shifts, the canonical compare and select and the
    validity test."""
    W = -(-2 * k // 32)
    P = max_len - k + 1
    nbytes = B * Lw * 4 + (B * (Lw // 2) * 4 if with_vwords else B * 4) + B * P * (4 * W + 1)
    per_window = 10 * 2 * W + 3 * W + (3 * W if canonical else 0) + (
        6 * -(-k // 32) if with_vwords else 1)
    return nbytes, B * P * per_window


def kmer_table_row(W: int) -> int:
    """Bytes of a KmerTable row: W key words and a count."""
    return 4 * W + 4


def score_table_row(W: int) -> int:
    """Bytes of a ScoreTable row: W key words, the child count and the parents' counts."""
    return 4 * W + 8


def staged_row(W: int) -> int:
    """Bytes of a staged row: W key words and its valid flag."""
    return 4 * W + 1
