"""The benchmark's packer against the port's ``ops/pack.pack_seqs``."""

import numpy as np
import pytest
import torch

from gpubench import reads
from gpubench.tests.conftest import TINY_READS


def _strings(codes):
    return ["".join("ACGTN"[c] for c in row) for row in codes.tolist()]


def _spec(**kw):
    return reads.ReadSpec(**{**TINY_READS, "n_rate": 0.02, **kw})


@pytest.mark.parametrize("max_read_len", [160, 151, 100])
def test_pack_codes_equals_pack_seqs(max_read_len):
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.ops.pack import pack_seqs

    spec = _spec()
    haps = reads.haplotypes(spec, 7, "cpu")
    codes = reads.chunk_codes(spec, 7, "child", 0, haps["child"])[:300]
    assert (codes == reads.N_CODE).any(), "the reads should hold Ns"
    cfg = EngineConfig(k=31, max_read_len=max_read_len)
    want = pack_seqs(_strings(codes), cfg)
    words, vwords, length, has_n = reads.pack_codes(codes, max_read_len)
    assert np.array_equal(words.numpy().view(np.uint32), want.words)
    assert np.array_equal(vwords.numpy().view(np.uint32), want.vwords)
    assert np.array_equal(length.numpy(), want.length)
    assert bool(has_n.any()) == (not want.prefix_valid)


def test_reverse_strand_reads_are_reverse_complements():
    """Half the reads are reverse-complemented: each read or its reverse complement lies in
    its haplotypes, up to errors and Ns."""
    spec = _spec(err_rate=0.0, n_rate=0.0, het_rate=0.0)
    haps = reads.haplotypes(spec, 3, "cpu")
    codes = reads.chunk_codes(spec, 3, "mom", 0, haps["mom"])[:400]
    genome = "".join("ACGT"[c] for c in haps["mom"][0].tolist())
    rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
    fwd = sum(s in genome for s in _strings(codes))
    rev = sum("".join(rc[b] for b in reversed(s)) in genome for s in _strings(codes))
    assert fwd + rev == len(codes)
    assert 0.35 * len(codes) < rev < 0.65 * len(codes)


def test_sample_batches_equal_pack_seqs_batches():
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.ops.pack import PackedReads, pack_seqs

    spec = _spec(genome_len=6000, n_rate=0.0005)
    haps = reads.haplotypes(spec, 11, "cpu")
    sample = reads.pack_sample(spec, 11, "dad", haps["dad"], 128, 160, (31,), PackedReads)
    codes = torch.cat(list(reads.sample_chunks(spec, 11, "dad", haps["dad"])))
    cfg = EngineConfig(k=31, max_read_len=160)
    assert sample.n_reads == spec.reads == codes.shape[0]
    assert [b.n_reads for b in sample.batches][-1] == spec.reads % 128
    pv = []
    for i, b in enumerate(sample.batches):
        want = pack_seqs(_strings(codes[i * 128:(i + 1) * 128]), cfg, batch_size=128)
        assert np.array_equal(b.words, want.words)
        assert np.array_equal(b.vwords, want.vwords)
        assert np.array_equal(b.length, want.length)
        assert b.n_reads == want.n_reads
        assert b.prefix_valid == want.prefix_valid
        pv.append(b.prefix_valid)
    assert True in pv and False in pv
    windows = int(reads.window_ok(codes, 31).sum())
    assert sample.valid_windows[31] == windows


def test_reads_repeat_from_the_seed_and_differ_between_seeds():
    spec = _spec()

    def mom(seed):
        return reads.chunk_codes(spec, seed, "mom", 0, reads.haplotypes(spec, seed, "cpu")["mom"])

    a, b, c = mom(2**31 + 5), mom(2**31 + 5), mom(2**31 + 6)
    assert torch.equal(a, b)
    assert a.shape == c.shape and not torch.equal(a, c)


@pytest.mark.cuda
def test_pack_on_the_card_equals_the_cpu(cuda_device):
    spec = _spec()
    haps = reads.haplotypes(spec, 5, "cpu")
    codes = reads.chunk_codes(spec, 5, "child", 0, haps["child"])
    for a, b in zip(reads.pack_codes(codes, 160), reads.pack_codes(codes.to(cuda_device), 160)):
        assert torch.equal(a, b.cpu())
