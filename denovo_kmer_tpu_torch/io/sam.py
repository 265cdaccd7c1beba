"""SAM text output: the writer half of ``denovo_kmer_tpu/io/sam.py`` (``format_sam_record``,
``sam_header_lines``), which evidence output (``-o reads.sam``) writes through. Reading SAM
input is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from denovo_kmer_tpu_torch.io.bam import BamRecord

#: CIGAR operation characters by BAM op code (SAMv1 §4.2.2)
CIGAR_OPS = "MIDNSHP=X"


def format_sam_record(r: BamRecord, names: Sequence[str]) -> str:
    """One record → one SAM line."""
    cig = "".join(f"{n}{CIGAR_OPS[op]}" for n, op in r.cigar) or "*"
    qual = "*" if r.qual is None else "".join(chr(q + 33) for q in r.qual)
    rname = names[r.refid] if 0 <= r.refid < len(names) else "*"
    nrname = (
        "=" if r.next_refid == r.refid and r.refid >= 0
        else (names[r.next_refid] if 0 <= r.next_refid < len(names) else "*")
    )
    return "\t".join([
        r.name, str(r.flag), rname, str(r.pos + 1), str(r.mapq), cig,
        nrname, str(r.next_pos + 1), str(r.tlen), r.seq or "*", qual,
    ])


def sam_header_lines(references: Sequence[Tuple[str, int]],
                     header_text: str = "@HD\tVN:1.6\tSO:unsorted") -> List[str]:
    return [header_text] + [f"@SQ\tSN:{n}\tLN:{L}" for n, L in references]
