"""The plain reference against a brute-force count, and its control against it."""

from collections import Counter

import pytest
import torch

from gpubench import harness, reads, reference
from gpubench.tests.conftest import TINY_READS

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _value(s):
    v = 0
    for b in s:
        v = 4 * v + "ACGT".index(b)
    return v


def brute(strings, k, canonical=True):
    counts = Counter()
    for s in strings:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if "N" in w:
                continue
            v = _value(w)
            if canonical:
                v = min(v, _value("".join(COMP[b] for b in reversed(w))))
            counts[v] += 1
    return counts


def brute_call(samples, k, tau, min_child, canonical=True):
    c = {s: brute(samples[s], k, canonical) for s in samples}
    rows = sorted((v, n, c["mom"].get(v, 0), c["dad"].get(v, 0))
                  for v, n in c["child"].items()
                  if n >= min_child and c["mom"].get(v, 0) <= tau and c["dad"].get(v, 0) <= tau)
    return {s: len(c[s]) for s in c}, rows


def _samples(spec, seed):
    haps = reads.haplotypes(spec, seed, "cpu")
    return haps, {s: ["".join("ACGTN"[x] for x in row)
                      for ch in reads.sample_chunks(spec, seed, s, haps[s])
                      for row in ch.tolist()] for s in reads.SAMPLES}


@pytest.mark.parametrize("k,canonical,tau,min_child", [
    (5, True, 0, 2), (15, True, 0, 2), (31, True, 0, 2), (31, False, 1, 3), (33, True, 0, 2),
    (41, True, 0, 2), (47, True, 2, 2)])
def test_reference_equals_brute_force(k, canonical, tau, min_child):
    spec = reads.ReadSpec(**{**TINY_READS, "genome_len": 3000, "coverage": 6,
                             "err_rate": 0.01, "n_rate": 0.01})
    haps, strings = _samples(spec, 21)
    want_n, want_rows = brute_call(strings, k, tau, min_child, canonical)
    got = reference.trio_answer(lambda s: reads.sample_chunks(spec, 21, s, haps[s]), k,
                                canonical, 160, tau, min_child)
    assert got.tables_n == want_n
    assert got.rows() == want_rows
    assert len(want_rows) > 0
    lines = got.report().splitlines()
    assert lines[0] == "#kmer\tchild_count\tmom_count\tdad_count"
    assert [(_value(x.split("\t")[0]), *map(int, x.split("\t")[1:])) for x in lines[1:]] \
        == want_rows


def test_reference_cuts_reads_to_max_read_len():
    spec = reads.ReadSpec(**{**TINY_READS, "genome_len": 2000, "coverage": 4})
    haps, strings = _samples(spec, 4)
    cut = {s: [x[:100] for x in v] for s, v in strings.items()}
    want_n, want_rows = brute_call(cut, 31, 0, 2)
    got = reference.trio_answer(lambda s: reads.sample_chunks(spec, 4, s, haps[s]), 31,
                                True, 100, 0, 2)
    assert got.tables_n == want_n and got.rows() == want_rows


def test_control_fails_the_check():
    """The control (k-mers counted by a fingerprint one key word narrower than their value)
    misses the exact comparison at a size where fingerprints collide."""
    spec = reads.ReadSpec(**{**TINY_READS, "genome_len": 400_000, "coverage": 3})
    haps = reads.haplotypes(spec, 8, "cpu")
    chunks = lambda s: reads.sample_chunks(spec, 8, s, haps[s])  # noqa: E731
    exact = {k: reference.trio_answer(chunks, k, True, 160, 0, 2) for k in (15, 31)}
    control = {k: reference.trio_answer(chunks, k, True, 160, 0, 2, reference.control_bits(k))
               for k in (15, 31)}
    numbers, failed = harness.compare(exact, [control])
    assert failed == 1
    assert numbers["k15_mom_n_off"][0] == 0  # one word holds k = 15: nothing narrower
    assert numbers["k31_mom_n_off"][0] > 0 and numbers["k31_child_n_off"][0] > 0
    assert harness.compare(exact, [exact])[1] == 0


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(cuda_device):
    """The same reads (made on the CPU: each device draws its own) counted on both."""
    spec = reads.ReadSpec(**{**TINY_READS, "genome_len": 5000})
    haps = reads.haplotypes(spec, 9, "cpu")
    for k in (31, 41):
        a, b = (reference.trio_answer(
            lambda s, d=d: (c.to(d) for c in reads.sample_chunks(spec, 9, s, haps[s])),
            k, True, 160, 0, 2) for d in ("cpu", cuda_device))
        assert a.tables_n == b.tables_n and a.rows() == b.rows()


def test_limbs_split_where_a_value_passes_62_bits():
    assert reference.limb_bases(31) == [(0, 31)]
    assert reference.limb_bases(41) == [(0, 25), (25, 41)]
    assert reference.control_bits(15) is None and reference.control_bits(31) == 32
    assert reference.control_bits(41) == 64
    with pytest.raises(ValueError):
        reference.limb_bases(48)
    codes = torch.tensor([[0, 1, 2, 3, 4, 0, 1]], dtype=torch.uint8)
    assert [v.tolist() for v in reference.window_keys(codes, 2, canonical=False)] == [[1, 6, 11, 1]]
