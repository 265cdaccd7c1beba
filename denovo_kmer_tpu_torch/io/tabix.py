"""Tabix (.tbi) index for BGZF-compressed coordinate-sorted VCF.

The reference's HTSlib stack ships tabix for region queries over bgzipped text
(inferred from its CI dependency set);
trio workflows use it to subset truth/callset VCFs to a region. This implements the
VCF preset of the tabix format: the BAI binning scheme (reg2bin/reg2bins, shared with
io/bai.py) over (CHROM, POS, end) keys parsed from the text lines, chunks addressed by
BGZF virtual offsets, plus the 16 kb linear index. ``read_vcf_region`` resolves a
region through the index and yields full VcfRecords.

Layout (little-endian, whole index BGZF-compressed — tabix spec §"The binary format"):
magic "TBI\\1", n_ref, format(2=VCF), col_seq(1), col_beg(2), col_end(0), meta('#'),
skip(0), l_nm + NUL-joined names; per ref: n_bin {bin, n_chunk, (cnk_beg,cnk_end)…},
n_intv, ioff[…]. Bin 37450 is the htslib pseudo-bin (file range + record counts).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

from denovo_kmer_tpu_torch.io.bai import BamIndex, RefIndex, reg2bin
from denovo_kmer_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, is_bgzf
from denovo_kmer_tpu_torch.io.vcf import VcfRecord, parse_vcf_line

TBI_MAGIC = b"TBI\x01"
_PSEUDO_BIN = 37450
_FMT_VCF = 2


def _vcf_key(cols: List[bytes]) -> Tuple[bytes, int, int]:
    """(chrom, 0-based beg, 0-based excl end) of one VCF data line. End comes
    from INFO END= when present (symbolic/structural alleles), else POS+len(REF)
    — the tabix VCF preset's convention."""
    chrom = cols[0]
    beg = int(cols[1]) - 1
    end = beg + max(len(cols[3]), 1)
    if len(cols) > 7:
        for kv in cols[7].split(b";"):
            if kv.startswith(b"END="):
                try:
                    end = max(int(kv[4:]), beg + 1)
                except ValueError:
                    pass
                break
    return chrom, beg, end


def write_tbi(vcf_gz_path: str, tbi_path: Optional[str] = None) -> str:
    """Index a BGZF-compressed, coordinate-sorted VCF. Refuses plain gzip (no
    random access) and unsorted input, like ``tabix -p vcf``."""
    if not is_bgzf(vcf_gz_path):
        raise ValueError(
            f"{vcf_gz_path!r} is not BGZF-compressed; tabix needs bgzip output "
            f"(write_vcf(..., bgzf=True) or bgzip the file)"
        )
    tbi_path = tbi_path or vcf_gz_path + ".tbi"
    names: List[bytes] = []
    name_id: Dict[bytes, int] = {}
    bins: List[Dict[int, List[Tuple[int, int]]]] = []
    linear: List[List[int]] = []
    counts: List[int] = []
    ref_first: List[int] = []
    ref_last: List[int] = []
    prev_beg = -1
    with open(vcf_gz_path, "rb") as f:
        r = BgzfReader(f)
        while True:
            vo0 = r.tell_virtual()
            line = r.readline()
            if not line:
                break
            if line.startswith(b"#"):
                continue
            vo1 = r.tell_virtual()
            cols = line.rstrip(b"\r\n").split(b"\t")
            if len(cols) < 8:
                raise ValueError(f"truncated VCF line at voffset {vo0:#x}")
            chrom, beg, end = _vcf_key(cols)
            rid = name_id.get(chrom)
            if rid is None:
                rid = name_id[chrom] = len(names)
                names.append(chrom)
                bins.append({})
                linear.append([])
                counts.append(0)
                ref_first.append(vo0)
                ref_last.append(vo1)
                prev_beg = -1
            elif rid != len(names) - 1:
                raise ValueError(
                    f"VCF not coordinate-sorted: {chrom.decode()} reappears after "
                    f"other contigs (sort with `bcftools sort` first)"
                )
            if beg < prev_beg:
                raise ValueError(
                    f"VCF not coordinate-sorted at {chrom.decode()}:{beg + 1}"
                )
            prev_beg = beg
            counts[rid] += 1
            ref_last[rid] = vo1
            b = reg2bin(beg, end)
            blist = bins[rid].setdefault(b, [])
            if blist and vo0 <= blist[-1][1]:
                blist[-1] = (blist[-1][0], vo1)  # extend the adjacent chunk
            else:
                blist.append((vo0, vo1))
            lin = linear[rid]
            w0, w1 = beg >> 14, (end - 1) >> 14
            if len(lin) <= w1:
                lin.extend([0] * (w1 + 1 - len(lin)))
            for w in range(w0, w1 + 1):
                if lin[w] == 0:
                    lin[w] = vo0
    # forward-fill empty linear windows (tabix convention: never point backwards)
    for lin in linear:
        prev = lin[0] if lin else 0
        for i, v in enumerate(lin):
            if v == 0:
                lin[i] = prev
            else:
                prev = v

    out = bytearray()
    out += TBI_MAGIC
    nm = b"\x00".join(names) + b"\x00" if names else b""
    out += struct.pack("<8i", len(names), _FMT_VCF, 1, 2, 0, ord("#"), 0, len(nm))
    out += nm
    for rid in range(len(names)):
        rbins = bins[rid]
        out += struct.pack("<i", len(rbins) + 1)  # + pseudo-bin
        for b in sorted(rbins):
            chunks = rbins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        # htslib pseudo-bin: this ref's voffset range + (placed, placeless) counts
        out += struct.pack("<Ii", _PSEUDO_BIN, 2)
        out += struct.pack("<QQ", ref_first[rid], ref_last[rid])
        out += struct.pack("<QQ", counts[rid], 0)
        out += struct.pack("<i", len(linear[rid]))
        for v in linear[rid]:
            out += struct.pack("<Q", v)
    with open(tbi_path, "wb") as f, BgzfWriter(f) as w:
        w.write(bytes(out))
    return tbi_path


def read_tbi(tbi_path: str) -> Tuple[BamIndex, List[str]]:
    """Parse a .tbi (local or URL) → (BamIndex with the VCF preset's bins/linear,
    contig names)."""
    from denovo_kmer_tpu_torch.io.remote import open_binary

    with open_binary(tbi_path) as f:
        data = BgzfReader(f).read(1 << 40)
    if data[:4] != TBI_MAGIC:
        raise ValueError(f"bad tabix magic in {tbi_path}")
    pos = 4
    n_ref, fmt, _cs, _cb, _ce, _meta, _skip, l_nm = struct.unpack_from(
        "<8i", data, pos)
    pos += 32
    if fmt != _FMT_VCF:
        raise ValueError(f"{tbi_path}: tabix preset {fmt} is not VCF (2)")
    names = [n.decode() for n in data[pos : pos + l_nm].split(b"\x00") if n]
    pos += l_nm
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, pos)
        pos += 4
        rbins: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, pos)
            pos += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, pos)
                pos += 16
                chunks.append((cb, ce))
            if b != _PSEUDO_BIN:
                rbins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, pos)
        pos += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, pos))
        pos += 8 * n_intv
        refs.append(RefIndex(bins=rbins, linear=lin))
    return BamIndex(refs=refs), names


def _parse_simple_region(region: str, names: List[str]) -> Tuple[int, int, int]:
    """'chr', 'chr:beg-end' (1-based inclusive) → (refid, 0-based beg, excl end)."""
    name, _, span = region.partition(":")
    if name not in names:
        raise ValueError(f"region contig {name!r} not in the index "
                         f"(has: {', '.join(names[:10])})")
    rid = names.index(name)
    if not span:
        return rid, 0, 1 << 31
    b, _, e = span.replace(",", "").partition("-")
    beg = int(b) - 1 if b else 0
    end = int(e) if e else 1 << 31
    if beg < 0 or end <= beg:
        raise ValueError(f"bad region span {region!r}")
    return rid, beg, end


def read_vcf_region(
    vcf_gz_path: str, region: str, tbi_path: Optional[str] = None
) -> Iterator[VcfRecord]:
    """Records overlapping ``region`` via the .tbi (built on demand), in file order.

    Sample columns are parsed against the header like VcfReader does."""
    import os

    tbi_path = tbi_path or vcf_gz_path + ".tbi"
    if "://" not in tbi_path and not os.path.exists(tbi_path):
        write_tbi(vcf_gz_path, tbi_path)
    try:
        index, names = read_tbi(tbi_path)
    except Exception as e:
        if "://" in tbi_path:
            raise ValueError(
                f"remote VCF region query needs a served index: {tbi_path} "
                f"(index the file where it is hosted) — {e}") from e
        raise
    rid, beg, end = _parse_simple_region(region, names)
    chunks = index.region_chunks(rid, beg, end)  # already merged + sorted
    if not chunks:
        return
    target = names[rid].encode()
    from denovo_kmer_tpu_torch.io.remote import open_binary

    with open_binary(vcf_gz_path) as f:
        r = BgzfReader(f)
        # samples from the header (needed to parse FORMAT/sample columns)
        samples: List[str] = []
        while True:
            line = r.readline()
            if not line or not line.startswith(b"#"):
                break
            if line.startswith(b"#CHROM"):
                samples = line.decode().rstrip("\r\n").split("\t")[9:]
        for cb, ce in chunks:
            r.seek_virtual(cb)
            while r.tell_virtual() < ce:
                line = r.readline()
                if not line:
                    break
                if line.startswith(b"#"):
                    continue
                cols = line.rstrip(b"\r\n").split(b"\t")
                chrom, rbeg, rend = _vcf_key(cols)
                if chrom != target:
                    continue
                if rbeg >= end:
                    return  # sorted: nothing later can overlap
                if rend > beg:
                    yield parse_vcf_line(line.decode().rstrip("\r\n"), samples)
