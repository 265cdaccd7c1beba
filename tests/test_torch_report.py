"""The report built column-wise (``pipeline._trio_result``, ``format_report_np``,
``decode_kmers_np``) against the oracle's per-row TSV, the JAX package's ``format_report_np``
and the per-row candidate tuples, at every key width, at the edges of every decimal digit and
of a uint32, and across the seams of the report's row chunks."""

import numpy as np
import pytest

from denovo_kmer_tpu.pipeline import format_report_np as jax_format_report_np
from denovo_kmer_tpu_torch import pipeline
from denovo_kmer_tpu_torch.config import words_per_kmer
from denovo_kmer_tpu_torch.oracle import decode_kmer, words_to_kmer_value
from denovo_kmer_tpu_torch.oracle.scalar import format_report
from denovo_kmer_tpu_torch.utils.metrics import Metrics

#: one word (k ≤ 16), two (17–32), three (33–48) and four (49–63), at and beside each edge
KS = (1, 15, 16, 17, 31, 32, 33, 41, 48, 63)
#: counts at the edges of a decimal digit, of the 4-digit groups and of a uint32
EDGES = np.array([0, 9, 10, 99, 100, 999, 1000, 9999, 10000, 10001, 99999, 100000,
                  99999999, 100000000, 100000001, 999999999, 1000000000, 4294967295],
                 np.uint32)


def _columns(k: int, n: int, seed: int):
    """(keys, child, mom, dad) of ``n`` random candidates at ``k``: keys masked to 2k bits,
    counts of every width, the first rows of each count column at ``EDGES``."""
    rng = np.random.default_rng(seed)
    W = words_per_kmer(k)
    keys = rng.integers(0, 2**32, (n, W), dtype=np.uint32)
    keys[:, 0] &= np.uint32((1 << (2 * k - 32 * (W - 1))) - 1)
    keys = keys[np.lexsort(keys.T[::-1])]
    counts = []
    for j in range(3):
        width = rng.integers(0, 33, n).astype(np.uint64)
        col = (rng.integers(0, 2**32, n, dtype=np.uint64) >> width).astype(np.uint32)
        edges = np.roll(EDGES, 5 * j)[:n]
        col[:len(edges)] = edges
        counts.append(col)
    return (keys, *counts)


def _per_row_candidates(keys, cc, mc, dc):
    """The candidate tuples one row at a time, as the report built them before."""
    return [(words_to_kmer_value(keys[i]), int(cc[i]), int(mc[i]), int(dc[i]))
            for i in range(keys.shape[0])]


def _check(k: int, cols):
    m = Metrics()
    m.count("candidates", 7)
    res = pipeline._trio_result(cols, k, m, {"child": 1})
    want = _per_row_candidates(*cols)
    assert res.candidates == want
    assert all(type(x) is int for row in res.candidates for x in row)
    assert res.report == format_report(want, k)
    assert res.report == jax_format_report_np(*cols, k)
    assert res.tables_n == {"child": 1} and res.metrics is m
    assert m.counters["candidates"] == 7 + len(want)
    assert pipeline.decode_kmers_np(cols[0], k) == [decode_kmer(v, k) for v, *_ in want]


@pytest.mark.parametrize("n", [0, 1, 3000], ids=["empty", "one_row", "random"])
@pytest.mark.parametrize("k", KS)
def test_trio_result_matches_the_per_row_report(k, n):
    _check(k, _columns(k, n, seed=1000 * k + n))


@pytest.mark.parametrize("k", (15, 33, 63))
def test_row_chunks_join_at_their_seams(k, monkeypatch):
    monkeypatch.setattr(pipeline, "_REPORT_CHUNK_ROWS", 1000)
    _check(k, _columns(k, 2500, seed=k))


def test_a_report_longer_than_one_row_chunk():
    n = pipeline._REPORT_CHUNK_ROWS + 3
    _check(41, _columns(41, n, seed=41))


def test_keys_above_the_k_mer_stay_in_the_values_and_out_of_the_text():
    keys = np.array([[0xFFFFFFFF, 0x00000001], [0x80000000, 0xFFFFFFFF]], np.uint32)
    cc = np.array([3, 4], np.uint32)
    res = pipeline._trio_result((keys, cc, cc, cc), 17, Metrics(), {})
    assert [v for v, *_ in res.candidates] == [0xFFFFFFFF00000001, 0x80000000FFFFFFFF]
    assert pipeline.decode_kmers_np(keys, 17) == ["TAAAAAAAAAAAAAAAC", "ATTTTTTTTTTTTTTTT"]
    assert res.report.splitlines()[1:] == ["TAAAAAAAAAAAAAAAC\t3\t3\t3",
                                           "ATTTTTTTTTTTTTTTT\t4\t4\t4"]
    assert res.report == jax_format_report_np(keys, cc, cc, cc, 17)
