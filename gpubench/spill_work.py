"""The spill's per-layer readings: whether a run has any, and the bytes its partition step
needs.

The port records ``spill.partition``, ``spill.store`` and ``spill.fold`` spans
(``denovo_kmer_tpu_torch/ops/spill.py``) only while a profiler runs; a port without them has
none, and its ``rows_partitioned`` and ``rows_spilled`` tallies read 0, so each reader of the
spill's metrics asks ``spilled`` first.
"""

from __future__ import annotations

from gpubench import roofline


def spilled(run) -> bool:
    """Whether every trio of the window recorded a ``spill.partition`` span."""
    return bool(run.trios) and all(
        any(r.name == "spill.partition" for r in t.metrics.spans) for t in run.trios)


def words(run) -> int:
    """Key words a row at the window's k (one k: the spill takes one)."""
    k = next(iter(run.trios[0].results))
    return -(-2 * k // 32)


def partition_bytes(rows_partitioned: float, rows_spilled: float, W: int) -> float:
    """Bytes the partition step needs: each staged row (W key words and its valid flag) read
    once, each spilled row (W key words) written once to its pass block."""
    return rows_partitioned * roofline.staged_row(W) + rows_spilled * 4 * W
