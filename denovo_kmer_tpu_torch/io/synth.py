"""Deterministic synthetic trio generator — the hermetic test fixture factory.

A copy of ``denovo_kmer_tpu/io/synth.py``: for the same ``TrioSpec`` it draws the same
``random.Random`` sequence and so gives the same records. A trio is simulated as: a random
reference genome, two parental haplotype pairs with inherited SNVs, a child inheriting one
haplotype from each parent plus a set of *de novo* SNVs — whose flanking k-mers are the
candidates the engine must recover.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Sequence, Tuple

from denovo_kmer_tpu_torch.io.bam import BamRecord, BamWriter

_BASES = "ACGT"


@dataclasses.dataclass
class TrioSpec:
    genome_len: int = 20_000
    read_len: int = 100
    coverage: float = 12.0
    n_inherited_snvs: int = 30
    n_denovo_snvs: int = 5
    error_rate: float = 0.0  # per-base sequencing error probability
    n_rate: float = 0.001  # per-base N probability
    dup_fraction: float = 0.02  # records flagged as duplicates (must be filtered)
    unmapped_fraction: float = 0.02  # records flagged unmapped (filtered by default)
    seed: int = 0
    ref_name: str = "chr20"


@dataclasses.dataclass
class SynthTrio:
    spec: TrioSpec
    reference: str
    haplotypes: Dict[str, Tuple[str, str]]  # sample -> (hap1, hap2)
    denovo_positions: List[int]
    reads: Dict[str, List[BamRecord]]  # sample -> records


def _mutate(seq: str, positions: Sequence[int], rng: random.Random) -> str:
    s = list(seq)
    for p in positions:
        old = s[p]
        s[p] = rng.choice([b for b in _BASES if b != old])
    return "".join(s)


def _sample_reads(
    hap_pair: Tuple[str, str],
    spec: TrioSpec,
    rng: random.Random,
    sample: str,
) -> List[BamRecord]:
    n_reads = int(spec.coverage * spec.genome_len / spec.read_len)
    recs: List[BamRecord] = []
    for i in range(n_reads):
        hap = hap_pair[rng.random() < 0.5]
        pos = rng.randrange(0, len(hap) - spec.read_len + 1)
        frag = hap[pos : pos + spec.read_len]
        reverse = rng.random() < 0.5
        flag = 0x10 if reverse else 0
        # BAM SEQ is stored reference-forward; strand only flips the flag here.
        bases = list(frag)
        for j in range(len(bases)):
            r = rng.random()
            if r < spec.n_rate:
                bases[j] = "N"
            elif r < spec.n_rate + spec.error_rate:
                bases[j] = rng.choice([b for b in _BASES if b != bases[j]])
        seq = "".join(bases)
        qual = tuple(rng.randrange(25, 41) for _ in range(len(seq)))
        r = rng.random()
        if r < spec.dup_fraction:
            flag |= 0x400
        elif r < spec.dup_fraction + spec.unmapped_fraction:
            flag |= 0x4
        recs.append(
            BamRecord(
                name=f"{sample}_r{i}", flag=flag, refid=0, pos=pos, mapq=60,
                cigar=((spec.read_len, 0),), seq=seq, qual=qual,
            )
        )
    return recs


def make_trio(spec: TrioSpec) -> SynthTrio:
    rng = random.Random(spec.seed)
    ref = "".join(rng.choice(_BASES) for _ in range(spec.genome_len))

    def pick_positions(n: int, taken: set) -> List[int]:
        out: List[int] = []
        while len(out) < n:
            p = rng.randrange(spec.genome_len)
            if p not in taken:
                taken.add(p)
                out.append(p)
        return out

    taken: set = set()
    mom_snvs = (pick_positions(spec.n_inherited_snvs, taken),
                pick_positions(spec.n_inherited_snvs, taken))
    dad_snvs = (pick_positions(spec.n_inherited_snvs, taken),
                pick_positions(spec.n_inherited_snvs, taken))
    denovo = sorted(pick_positions(spec.n_denovo_snvs, taken))

    mom = (_mutate(ref, mom_snvs[0], rng), _mutate(ref, mom_snvs[1], rng))
    dad = (_mutate(ref, dad_snvs[0], rng), _mutate(ref, dad_snvs[1], rng))
    # child inherits mom hap 0 and dad hap 0, then gains de novo SNVs on the maternal copy
    child = (_mutate(mom[0], denovo, rng), dad[0])

    haps = {"mom": mom, "dad": dad, "child": child}
    reads = {s: _sample_reads(h, spec, rng, s) for s, h in haps.items()}
    return SynthTrio(
        spec=spec, reference=ref, haplotypes=haps,
        denovo_positions=denovo, reads=reads,
    )


def write_trio_bams(trio: SynthTrio, outdir: str) -> Dict[str, str]:
    """Write mom/dad/child BAMs; returns {sample: path}."""
    os.makedirs(outdir, exist_ok=True)
    paths = {}
    refs = [(trio.spec.ref_name, trio.spec.genome_len)]
    for sample, recs in trio.reads.items():
        path = os.path.join(outdir, f"{sample}.bam")
        with open(path, "wb") as f, BamWriter(f, references=refs) as w:
            for r in recs:
                w.write(r)
        paths[sample] = path
    return paths


def write_truth_vcf(trio: SynthTrio, path: str) -> str:
    """Planted-truth VCFv4.2 of the trio's de novo SNVs, the same text the JAX package's
    ``write_truth_vcf`` writes uncompressed. REF from the shared reference, ALT from
    whichever child haplotype diverges at the planted position."""
    h1, h2 = trio.haplotypes["child"]
    name = trio.spec.ref_name
    lines = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID={name},length={trio.spec.genome_len}>",
        "\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
                   "FORMAT", "child"]),
    ]
    for p in sorted(trio.denovo_positions):
        ref = trio.reference[p]
        alt = h1[p] if h1[p] != ref else h2[p]
        lines.append("\t".join([name, str(p + 1), ".", ref, alt, ".", "PASS", "DENOVO",
                                "GT", "0/1"]))
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
    return path
