"""The table steps that merge (``flush``, ``flush_score``, ``seed_score_table``,
``merge_tables``, ``merge_score_tables``) against the sort of everything
(``ops/table._aggregate_parts``) over the same parts, bit for bit in keys, weights and
``n``, at W = 1, 2, 3, 4 (k = 16, 31, 41, 63); and the merge kernel (``csrc/table_merge.cu``)
against its plain version on the card (``cuda``-marked)."""

import os
import sys

import numpy as np
import pytest
import torch

from denovo_kmer_tpu_torch.ops import table_merge
from denovo_kmer_tpu_torch.ops.score import (
    ScoreTable,
    _sat16,
    empty_score_table,
    flush_score,
    merge_score_tables,
    seed_score_table,
)
from denovo_kmer_tpu_torch.ops.stream import KmerAccumulator, flush, staged_valid
from denovo_kmer_tpu_torch.ops.table import (
    KmerTable,
    _aggregate_parts,
    _sticky_overflow_n,
    merge_tables,
    valid_rows,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (the smoke script's merge cases)

torch.set_num_threads(1)

ONES = 0xFFFFFFFF
WORDS = {16: 1, 31: 2, 41: 3, 63: 4}
CASES = ["empty_table", "empty_window", "disjoint", "overlap", "fill_below_slots",
         "invalid_rows", "all_ones", "wrap", "above_capacity", "tight_seed_then_grow"]


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def _pool(rng, n, W):
    """n distinct (n, W) uint32 keys, lexicographically sorted, none all ones: words small
    or at or above 2^31, so that keys share words and order unsigned."""
    keys = rng.integers(0, 6, size=(4 * n, W)).astype(np.uint32)
    keys |= (rng.random((4 * n, W)) < 0.5).astype(np.uint32) << 31
    keys[:, -1] = rng.integers(0, 1 << 32, size=4 * n, dtype=np.uint64).astype(np.uint32)
    keys = np.unique(keys, axis=0)
    keys = keys[~(keys == ONES).all(axis=1)]
    return keys[np.sort(rng.choice(len(keys), size=n, replace=False))]


def _table(keys, counts, C):
    """A KmerTable of sorted unique ``keys`` with ``counts``, cut to C rows: with more keys
    than C, an overflowed table, whose ``n`` (the key count) exceeds C."""
    W = keys.shape[1]
    m = min(len(keys), C)
    k = np.full((C, W), ONES, np.uint32)
    c = np.zeros(C, np.uint32)
    k[:m], c[:m] = keys[:m], counts[:m]
    return KmerTable(_bits(k), _bits(c), torch.tensor(len(keys)))


def _acc(rows, valid, slots):
    """A staging buffer of ``slots`` rows holding ``rows`` first; the rows past them are
    stale, valid keys of their own, as a buffer reused after a flush holds."""
    rng = np.random.default_rng(len(rows))
    W = rows.shape[1]
    k = rng.integers(0, 1 << 32, size=(slots, W), dtype=np.uint64).astype(np.uint32)
    v = np.ones(slots, bool)
    k[:len(rows)], v[:len(rows)] = rows, valid
    return KmerAccumulator(_bits(k), torch.from_numpy(v), len(rows))


def _case(name, W, seed):
    """(table, staging buffer, table capacity) of one case."""
    rng = np.random.default_rng(seed)
    C = 128
    pool = _pool(rng, 96, W)
    t_keys = pool[np.sort(rng.choice(96, size=40, replace=False))]
    counts = rng.integers(1, 1 << 32, size=96, dtype=np.uint64).astype(np.uint32)
    w_rows = pool[rng.integers(0, 96, size=150)]
    valid = rng.random(150) < 0.85
    slots = 150
    if name == "empty_table":
        t_keys = t_keys[:0]
    elif name == "empty_window":
        w_rows, valid = w_rows[:0], valid[:0]
    elif name == "disjoint":
        t_keys = pool[0::2][:40]
        w_rows = pool[1::2][rng.integers(0, 48, size=150)]
    elif name == "overlap":
        w_rows = np.concatenate([t_keys, t_keys[rng.integers(0, 40, size=110)]])
        valid[:] = True
    elif name == "fill_below_slots":
        slots = 256
    elif name == "invalid_rows":
        valid = rng.random(150) < 0.3
        w_rows[~valid] = rng.integers(0, 1 << 32, size=(int((~valid).sum()), W),
                                      dtype=np.uint64).astype(np.uint32)
        w_rows[np.flatnonzero(~valid)[::3]] = ONES  # invalid rows with the all-ones key
    elif name == "all_ones":
        t_keys = np.concatenate([t_keys, np.full((1, W), ONES, np.uint32)])
        w_rows[::7] = ONES
    elif name == "wrap":
        # the all-ones key at 2^32 - 1 in the table and once in the window: its sum wraps to
        # 0 and the row is stripped as the invalid rows' group is; another key wraps too
        t_keys = np.concatenate([t_keys, np.full((1, W), ONES, np.uint32)])
        counts[:len(t_keys)] = ONES
        w_rows[0] = ONES
        valid[0] = True
        w_rows[1:][(w_rows[1:] == ONES).all(axis=1)] = 0
    elif name == "above_capacity":
        # the table has overflowed already: 48 real rows of 50 keys, its n stays above C
        t_keys = pool[np.sort(rng.choice(96, size=50, replace=False))]
        C = 48
    elif name == "tight_seed_then_grow":
        pass
    table = _table(t_keys, counts[:len(t_keys)], C)
    return table, _acc(w_rows, valid[:len(w_rows)], slots), C


def _pcounts(table, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 1 << 32, size=table.capacity, dtype=np.uint64).astype(np.uint32)
    p[int(min(int(table.n), table.capacity)):] = 0
    return _bits(p)


def _same(got, want_keys, want_cols, want_n, what):
    assert torch.equal(got.keys, want_keys), what
    for g, w in zip([got.counts, getattr(got, "pcounts", None)], want_cols):
        assert torch.equal(g, w), what
    assert got.n.dtype == torch.int64 and int(got.n) == int(want_n), what


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", sorted(WORDS))
def test_merging_steps_equal_the_sort_of_everything(k, case):
    W = WORDS[k]
    table, acc, C = _case(case, W, seed=100 * k + CASES.index(case))
    acc_copy = acc._replace(kmers=acc.kmers.clone(), valid=acc.valid.clone())
    staged = (acc.kmers, staged_valid(acc))

    # flush: the table and the staged rows (each valid row weighs 1)
    keys, cols, n = _aggregate_parts([(table.keys, valid_rows(table.n, C), [table.counts]),
                                      (*staged, [1])], C)
    out_acc, got = flush(acc, table)
    _same(got, keys, cols, _sticky_overflow_n(n, C, table.n > C), f"flush {case}")
    assert out_acc.fill == 0
    assert torch.equal(acc.kmers, acc_copy.kmers) and torch.equal(acc.valid, acc_copy.valid)

    # the seed: two parents' tables, counts saturated into the 16-bit halves of the pack
    dad = flush(acc, _table(np.zeros((0, W), np.uint32), np.zeros(0, np.uint32), C))[1]
    mom = table
    cap = C if case != "tight_seed_then_grow" else 2 * C  # mom's and dad's capacities
    keys, cols, n = _aggregate_parts(
        [(mom.keys, valid_rows(mom.n, mom.capacity), [0, _sat16(mom.counts)]),
         (dad.keys, valid_rows(dad.n, dad.capacity), [0, _sat16(dad.counts) << 16])], cap)
    seed = seed_score_table(mom, dad, cap)
    _same(seed, keys, cols, n, f"seed {case}")

    # merge_tables: the table and the window flushed into an empty table (dad)
    keys, cols, n = _aggregate_parts([(table.keys, valid_rows(table.n, C), [table.counts]),
                                      (dad.keys, valid_rows(dad.n, C), [dad.counts])], C)
    _same(merge_tables(table, dad, C), keys, cols,
          _sticky_overflow_n(n, C, table.n > C, dad.n > C), f"merge_tables {case}")

    # flush_score: a scoring table with parental packs, and the staged rows (pcounts 0)
    if case == "tight_seed_then_grow":  # the pipeline's call lane: cut the seed, grow it
        tight = max(1 << (max(int(seed.n), 1) - 1).bit_length(), 8)
        stab = ScoreTable(seed.keys[:tight].clone(), seed.counts[:tight].clone(),
                          seed.pcounts[:tight].clone(), seed.n)
        out_c = 4 * C
    else:
        stab = ScoreTable(table.keys, table.counts, _pcounts(table, k), table.n)
        out_c = 0
    Cs, Co = stab.capacity, out_c or stab.capacity
    keys, cols, n = _aggregate_parts(
        [(stab.keys, valid_rows(stab.n, Cs), [stab.counts, stab.pcounts]), (*staged, [1, 0])],
        Co)
    _out, got = flush_score(acc, stab, out_capacity=out_c)
    _same(got, keys, cols, _sticky_overflow_n(n, Co, stab.n > Cs), f"flush_score {case}")

    # merge_score_tables: that scoring table and the window flushed into an empty one
    window = flush_score(acc, empty_score_table(C, W, "cpu"))[1]
    keys, cols, n = _aggregate_parts(
        [(stab.keys, valid_rows(stab.n, Cs), [stab.counts, stab.pcounts]),
         (window.keys, valid_rows(window.n, C), [window.counts, window.pcounts])], Co)
    _same(merge_score_tables(stab, window, Co), keys, cols,
          _sticky_overflow_n(n, Co, stab.n > Cs, window.n > C), f"merge_score_tables {case}")


def test_merge_checks_its_inputs():
    a = torch.zeros((4, 2), dtype=torch.int32)
    n = torch.tensor(0)
    with pytest.raises(ValueError, match="weight columns"):
        table_merge.merge_rows(a, n, [None], a, n, [None, None], 4)
    with pytest.raises(ValueError, match="key widths"):
        table_merge.merge_rows(a, n, [None], torch.zeros((4, 3), dtype=torch.int32), n,
                               [None], 4)
    with pytest.raises(ValueError, match="0-dim int64"):
        table_merge.merge_rows(a, torch.tensor([0]), [None], a, n, [None], 4)
    with pytest.raises(ValueError, match="weights"):
        table_merge.merge_rows(a, n, [torch.zeros(3, dtype=torch.int32)], a, n, [None], 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        table_merge.merge_kernel(a, n, [None], a, n, [None], 4)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_plain_merge_equals_the_sort_of_everything(W):
    """chip_smoke.py's edge cases of the merge, on the CPU: the plain version against
    ``_aggregate_parts`` over both sides' valid rows (a None column weighs 0)."""
    for nc in (1, 2):
        for name, (ka, na, ca, kb, nb, cb, cap) in cs.table_merge_cases("cpu", W, nc, 200):
            keys, cols, n, rows = table_merge.merge_rows(ka, na, ca, kb, nb, cb, cap)
            want = _aggregate_parts(
                [(ka, valid_rows(na, ka.shape[0]), [0 if c is None else c for c in ca]),
                 (kb, valid_rows(nb, kb.shape[0]), [0 if c is None else c for c in cb])],
                cap)
            what = f"W={W} cols={nc} {name}"
            assert torch.equal(keys, want[0]), what
            assert all(torch.equal(g, w) for g, w in zip(cols, want[1])), what
            assert int(n) == int(want[2]), what
            assert int(rows) == min(int(na), ka.shape[0]) + min(int(nb), kb.shape[0]), what


@pytest.mark.cuda
def test_kernel_equals_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check on the H100)")
    dev = torch.device("cuda")
    assert cs.table_merge_edges(dev, [table_merge.merge_kernel]) > 0
    args, _vals = cs.table_merge_shape(dev, {"capacity": 1 << 22, "table_n": 3_000_000,
                                             "window_n": 2_000_000, "shared": 1_000_000})
    cs.compare_table_merge(table_merge.merge_kernel, args, "2^22 rows, 64-bit keys")


@pytest.mark.cuda
def test_a_trio_on_the_card_goes_through_the_merge_kernel(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
    from denovo_kmer_tpu_torch.pipeline import run_trio

    paths = write_trio_bams(make_trio(TrioSpec(genome_len=3000, read_len=60, coverage=8.0,
                                               seed=3)), str(tmp_path))
    cfg = EngineConfig(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 14,
                       accum_batches=2)
    before = table_merge.merge_kernel.launches
    on_card = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cuda")
    assert table_merge.merge_kernel.launches > before
    on_cpu = run_trio(paths["mom"], paths["dad"], paths["child"], cfg, device="cpu")
    assert on_card.report == on_cpu.report and on_card.tables_n == on_cpu.tables_n
