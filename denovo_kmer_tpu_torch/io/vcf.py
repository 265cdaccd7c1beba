"""VCF reader/writer — the feeder-side variant-file capability (SURVEY.md L1).

BASELINE.json's north star keeps "BAM/VCF decode host-side as a feeder"; the reference
reads VCF via vendored HTSlib (`ci.yml:18-27` dependency set). This is a self-contained
VCFv4.x text implementation: plain, gzip, or BGZF-compressed input (auto-detected — BGZF
*is* gzip, so one gzip path covers both), tab-field and INFO/FORMAT parsing, and a writer
used by ``io.synth`` to emit the planted-truth VCF for synthetic trios.

Scope: VCF text (the interchange format). BCF (binary) lives in ``io/bcf.py``
(reader+writer, differential-tested against this module on identical records);
tabix region queries over bgzipped VCF live in ``io/tabix.py``.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based, as in the file
    id: str
    ref: str
    alts: List[str]
    qual: Optional[float]
    filter: str
    info: Dict[str, Union[str, bool]]
    format: List[str]
    samples: List[Dict[str, str]]

    @property
    def is_snv(self) -> bool:
        return len(self.ref) == 1 and all(len(a) == 1 for a in self.alts)


def _open_text(path: str):
    from denovo_kmer_tpu_torch.io.remote import open_binary

    f = open_binary(path)
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":  # gzip/BGZF
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return io.TextIOWrapper(f, encoding="ascii")


def _parse_info(s: str) -> Dict[str, Union[str, bool]]:
    if s == "." or not s:
        return {}
    out: Dict[str, Union[str, bool]] = {}
    for item in s.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k] = v
        elif item:
            out[item] = True  # flag
    return out


class VcfReader:
    """Iterate VcfRecord from a VCF/VCF.gz path or http(s) URL; header retained."""

    def __init__(self, path: str):
        self._fh = _open_text(path)
        self.meta: List[str] = []
        self.samples: List[str] = []
        line = self._fh.readline()
        if not line.startswith("##fileformat=VCF"):
            raise ValueError(f"not a VCF file (missing ##fileformat): {path}")
        self.meta.append(line.rstrip("\r\n"))
        for line in self._fh:
            line = line.rstrip("\r\n")  # CRLF-produced VCFs are common
            if line.startswith("##"):
                self.meta.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if cols[:8] != ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                               "FILTER", "INFO"]:
                    raise ValueError("malformed #CHROM header line")
                self.samples = cols[9:]
                break
            else:
                raise ValueError("VCF data before #CHROM header line")
        else:
            raise ValueError("VCF has no #CHROM header line")

    def __iter__(self) -> Iterator[VcfRecord]:
        for line in self._fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            yield parse_vcf_line(line, self.samples)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_vcf_line(line: str, samples: Sequence[str] = ()) -> VcfRecord:
    """One VCF data line → VcfRecord (shared by VcfReader and tabix region reads)."""
    cols = line.split("\t")
    if len(cols) < 8:
        raise ValueError(f"VCF record has {len(cols)} fields (< 8): {line[:80]}")
    n_fixed = 8 + (1 if samples else 0) + len(samples)
    if samples and len(cols) != n_fixed:
        raise ValueError(
            f"VCF record has {len(cols)} fields, expected {n_fixed}: {line[:80]}"
        )
    fmt = cols[8].split(":") if len(cols) > 8 else []
    sample_maps = [dict(zip(fmt, c.split(":"))) for c in cols[9:]]
    return VcfRecord(
        chrom=cols[0],
        pos=int(cols[1]),
        id=cols[2],
        ref=cols[3],
        alts=[] if cols[4] == "." else cols[4].split(","),
        qual=None if cols[5] == "." else float(cols[5]),
        filter=cols[6],
        info=_parse_info(cols[7]),
        format=fmt,
        samples=sample_maps,
    )


def read_vcf_records(path: str) -> Iterator[VcfRecord]:
    with VcfReader(path) as r:
        yield from r


def _fmt_info(info: Dict[str, Union[str, bool]]) -> str:
    if not info:
        return "."
    parts = []
    for k, v in info.items():
        parts.append(k if v is True else f"{k}={v}")
    return ";".join(parts)


def write_vcf(
    path: str,
    records: Sequence[VcfRecord],
    contigs: Sequence[Tuple[str, int]] = (),
    samples: Sequence[str] = (),
    extra_meta: Sequence[str] = (),
    bgzf: bool = False,
) -> None:
    """Write a VCFv4.2 file (optionally BGZF-compressed via io.bgzf)."""
    lines = ["##fileformat=VCFv4.2"]
    for name, length in contigs:
        lines.append(f"##contig=<ID={name},length={length}>")
    lines.extend(extra_meta)
    header = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
    if samples:
        header.append("FORMAT")
        header.extend(samples)
    lines.append("\t".join(header))
    for r in records:
        cols = [
            r.chrom, str(r.pos), r.id or ".", r.ref,
            ",".join(r.alts) if r.alts else ".",
            "." if r.qual is None else f"{r.qual:g}",
            r.filter or ".", _fmt_info(r.info),
        ]
        if samples:
            cols.append(":".join(r.format) if r.format else ".")
            for s in r.samples:
                cols.append(":".join(s.get(k, ".") for k in r.format) if r.format
                            else ".")
        lines.append("\t".join(cols))
    payload = ("\n".join(lines) + "\n").encode("ascii")
    if bgzf:
        from denovo_kmer_tpu_torch.io.bgzf import BgzfWriter

        with open(path, "wb") as f:
            w = BgzfWriter(f)
            w.write(payload)
            w.close()
    else:
        with open(path, "wb") as f:
            f.write(payload)
