"""The port's candidate-site grouping (denovo_kmer_tpu_torch/sites.py) against the JAX
package's sites.group_sites on the CPU: the four cases of tests/test_sites.py (read-graph
fallback with duplicate names, per-read support, non-canonical candidates, zero-occurrence
candidates) and the mapped-position path on a BAM trio, each site TSV byte-equal to the one
the JAX package writes. Tolerance: byte-equal."""

import numpy as np
import pytest
import torch

from denovo_kmer_tpu.config import EngineConfig as JaxConfig
from denovo_kmer_tpu.sites import group_sites as jax_group_sites
from denovo_kmer_tpu.sites import write_sites_tsv as jax_write_sites_tsv
from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.io.synth import TrioSpec, make_trio, write_trio_bams
from denovo_kmer_tpu_torch.pipeline import run_trio
from denovo_kmer_tpu_torch.sites import group_sites, write_sites_tsv

torch.set_num_threads(1)

CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13)


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _canon(s):
    r = _rc(s)
    return s if s <= r else r


@pytest.fixture
def region():
    rng = np.random.default_rng(7)
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bytes(base[rng.integers(0, 4, 120)]).decode()


def _same_sites(tmp_path, child, tsv, cfg=CFG, device="cpu"):
    """Both packages' site TSVs of ``child`` and ``tsv``; asserts them byte-equal and
    returns the port's sites."""
    got = group_sites(str(child), str(tsv), EngineConfig(**cfg), device=device)
    want = jax_group_sites(str(child), str(tsv), JaxConfig(**cfg))
    write_sites_tsv(got, str(tmp_path / "port.sites.tsv"))
    jax_write_sites_tsv(want, str(tmp_path / "jax.sites.tsv"))
    text = (tmp_path / "port.sites.tsv").read_text()
    assert text == (tmp_path / "jax.sites.tsv").read_text()
    assert text.count("\n") == 1 + len(got)
    return got


def _fastq(path, reads):
    path.write_text("".join(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n" for name, seq in reads))


def test_readgraph_fallback_duplicate_names_and_spans(tmp_path, region):
    k = 21
    a, b = _canon(region[10:10 + k]), _canon(region[13:13 + k])
    d = _canon(region[80:80 + k])
    tsv = tmp_path / "cands.tsv"
    tsv.write_text("#kmer\tchild_count\tmom_count\tdad_count\n"
                   + f"{a}\t5\t0\t0\n{b}\t4\t0\t0\n{d}\t3\t0\t0\n")
    fq = tmp_path / "child.fastq"
    _fastq(fq, [("pair1", region[5:5 + 40]), ("pair1", region[75:75 + 40])])
    sites = _same_sites(tmp_path, fq, tsv)
    assert sorted(km for s in sites for km in s.kmers) == sorted([a, b, d])
    assert all(s.ref == "*" for s in sites)
    assert sorted([a, b]) in [sorted(s.kmers) for s in sites]


def test_support_counts_reads_not_occurrences(tmp_path):
    unit = "ACGTTGCAACGGATCCATAGG"
    km = _canon(unit)
    tsv = tmp_path / "c.tsv"
    tsv.write_text(f"#kmer\tchild_count\tmom_count\tdad_count\n{km}\t2\t0\t0\n")
    fq = tmp_path / "r.fastq"
    _fastq(fq, [("r1", unit + unit + "ACGT")])
    sites = _same_sites(tmp_path, fq, tsv)
    assert len(sites) == 1 and sites[0].n_reads == 1 and sites[0].max_child_count == 2


def test_non_canonical_candidate_strings_still_match(tmp_path, region):
    k = 21
    km = region[30:30 + k]
    noncanon = km if _canon(km) != km else _rc(km)
    tsv = tmp_path / "c.tsv"
    tsv.write_text(f"#kmer\tchild_count\n{noncanon}\t7\n")
    fq = tmp_path / "r.fastq"
    _fastq(fq, [("r", region[25:25 + 40])])
    sites = _same_sites(tmp_path, fq, tsv)
    assert len(sites) == 1 and sites[0].kmers == [noncanon] and sites[0].n_reads == 1


def test_positionless_zero_occurrence_candidate_not_dropped(tmp_path, region):
    k = 21
    present = _canon(region[10:10 + k])
    absent = _canon("A" * 10 + "CGTGACGTGAC")
    tsv = tmp_path / "c.tsv"
    tsv.write_text(f"#kmer\tc\n{present}\t3\n{absent}\t2\n")
    fq = tmp_path / "r.fastq"
    _fastq(fq, [("r", region[5:5 + 40])])
    sites = _same_sites(tmp_path, fq, tsv)
    got = {km: s for s in sites for km in s.kmers}
    assert set(got) == {present, absent} and got[absent].n_reads == 0


@pytest.fixture(scope="module")
def mapped_trio(tmp_path_factory):
    """A BAM trio whose reads carry alignment positions, and its call report."""
    d = tmp_path_factory.mktemp("sites")
    trio = make_trio(TrioSpec(genome_len=3000, read_len=60, coverage=8.0, n_denovo_snvs=4,
                              seed=5))
    paths = write_trio_bams(trio, str(d))
    res = run_trio(paths["mom"], paths["dad"], paths["child"], EngineConfig(**CFG),
                   device="cpu")
    assert res.candidates
    tsv = d / "cands.tsv"
    tsv.write_text(res.report)
    return paths, tsv, trio


def test_mapped_positions_match_jax(tmp_path, mapped_trio):
    """Position votes from mapped reads: sites on the reference, over the planted de novo
    SNVs that the call found (3 of the 4 at this coverage)."""
    paths, tsv, trio = mapped_trio
    sites = _same_sites(tmp_path, paths["child"], tsv)
    assert sites and all(s.ref != "*" for s in sites)
    covered = [p for p in trio.denovo_positions if any(s.start <= p < s.end for s in sites)]
    assert len(covered) >= 3, covered


def test_no_candidates_gives_no_sites(tmp_path, mapped_trio):
    paths, _, _ = mapped_trio
    tsv = tmp_path / "none.tsv"
    tsv.write_text("#kmer\tchild_count\tmom_count\tdad_count\n")
    assert _same_sites(tmp_path, paths["child"], tsv) == []


@pytest.mark.cuda
def test_sites_on_cuda_equal_cpu(tmp_path, mapped_trio):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 3 runs this on the H100)")
    paths, tsv, _ = mapped_trio
    gpu = group_sites(paths["child"], str(tsv), EngineConfig(**CFG), device="cuda")
    cpu = group_sites(paths["child"], str(tsv), EngineConfig(**CFG), device="cpu")
    assert gpu == cpu
