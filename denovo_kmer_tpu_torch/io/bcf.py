"""BCF 2.2 (binary VCF) reader/writer.

The reference's HTSlib stack reads and writes BCF natively (inferred from its CI
dependency set); this closes the
one format io/vcf.py had scoped out. Clean-room implementation of the BCFv2.2
spec (SAMv1/VCFv4.x companion): BGZF container, ``BCF\\x02\\x02`` magic, the
VCF-text header with IDX dictionaries, and typed-value record encoding
(l_shared/l_indiv split, CHROM/POS/rlen/QUAL, typed ID/alleles/FILTER/INFO and
per-sample FORMAT vectors, GT integer encoding).

Surface mirrors io/vcf.py: ``BcfReader``/``read_bcf_records`` yield the same
``VcfRecord`` the text reader produces (INFO values as strings, GT rendered
``0/1`` style), and ``write_bcf`` mirrors ``write_vcf``. Differential tests pin
text-vs-binary equality on identical record streams.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from denovo_kmer_tpu_torch.io.bgzf import BgzfReader, BgzfWriter
from denovo_kmer_tpu_torch.io.vcf import VcfRecord

BCF_MAGIC = b"BCF\x02\x02"

# typed-value atom codes (spec §6.3.3)
_T_MISSING = 0
_T_INT8 = 1
_T_INT16 = 2
_T_INT32 = 3
_T_FLOAT = 5
_T_CHAR = 7

_INT_MISSING = {_T_INT8: -128, _T_INT16: -32768, _T_INT32: -2147483648}
_INT_EOV = {_T_INT8: -127, _T_INT16: -32767, _T_INT32: -2147483647}
_FLOAT_MISSING_BITS = 0x7F800001
_FLOAT_EOV_BITS = 0x7F800002


# ---------------------------------------------------------------------------
# typed-value codec
# ---------------------------------------------------------------------------

def _enc_typed_size(atom: int, n: int) -> bytes:
    if n < 15:
        return bytes([(n << 4) | atom])
    return bytes([0xF0 | atom]) + _enc_typed_int(n)


def _enc_typed_int(v: int) -> bytes:
    if -120 <= v <= 127:
        return bytes([(1 << 4) | _T_INT8]) + struct.pack("<b", v)
    if -32760 <= v <= 32767:
        return bytes([(1 << 4) | _T_INT16]) + struct.pack("<h", v)
    return bytes([(1 << 4) | _T_INT32]) + struct.pack("<i", v)


def _enc_int_vector(vals: Sequence[int]) -> bytes:
    """Smallest-width typed int vector (spec: one atom for the whole vector)."""
    if not vals:
        return _enc_typed_size(_T_MISSING, 0)
    lo, hi = min(vals), max(vals)
    if -120 <= lo and hi <= 127:
        atom, fmt = _T_INT8, "<b"
    elif -32760 <= lo and hi <= 32767:
        atom, fmt = _T_INT16, "<h"
    else:
        atom, fmt = _T_INT32, "<i"
    out = bytearray(_enc_typed_size(atom, len(vals)))
    for v in vals:
        out += struct.pack(fmt, v)
    return bytes(out)


def _enc_string(s: str) -> bytes:
    b = s.encode("ascii")
    return _enc_typed_size(_T_CHAR, len(b)) + b


class _Cursor:
    __slots__ = ("d", "p")

    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos

    def _atom(self) -> Tuple[int, int]:
        t = self.d[self.p]
        self.p += 1
        atom, n = t & 0x0F, t >> 4
        if n == 15:
            n = self.typed_int()
        return atom, n

    def typed_int(self) -> int:
        atom, n = self._atom()
        if atom not in (_T_INT8, _T_INT16, _T_INT32) or n != 1:
            raise ValueError(f"BCF: expected scalar typed int, got atom {atom} x{n}")
        return self._ints(atom, 1)[0]

    def _ints(self, atom: int, n: int) -> List[int]:
        fmt, w = {_T_INT8: ("<%db", 1), _T_INT16: ("<%dh", 2),
                  _T_INT32: ("<%di", 4)}[atom]
        out = list(struct.unpack_from(fmt % n, self.d, self.p))
        self.p += w * n
        return out

    def typed_value(self):
        """One typed value → ('missing'|'int'|'float'|'char', payload)."""
        atom, n = self._atom()
        if atom == _T_MISSING:
            return "missing", None
        if atom in (_T_INT8, _T_INT16, _T_INT32):
            vals = self._ints(atom, n)
            eov = _INT_EOV[atom]
            vals = [None if v == _INT_MISSING[atom] else v
                    for v in vals if v != eov]
            return "int", vals
        if atom == _T_FLOAT:
            raw = struct.unpack_from(f"<{n}I", self.d, self.p)
            self.p += 4 * n
            vals = []
            for bits in raw:
                if bits == _FLOAT_EOV_BITS:
                    continue
                vals.append(None if bits == _FLOAT_MISSING_BITS
                            else struct.unpack("<f", struct.pack("<I", bits))[0])
            return "float", vals
        if atom == _T_CHAR:
            s = self.d[self.p : self.p + n].decode("ascii")
            self.p += n
            return "char", s.rstrip("\x00")
        raise ValueError(f"BCF: unknown typed atom {atom}")


# ---------------------------------------------------------------------------
# header dictionaries
# ---------------------------------------------------------------------------

def _hdr_field(line: str, key: str) -> Optional[str]:
    """Value of ``key=`` inside a ``##TYPE=<...>`` header line (no quote nesting
    in the fields we need: ID, IDX, length)."""
    body = line[line.index("<") + 1 : line.rindex(">")]
    for part in body.split(","):
        if part.startswith(key + "="):
            return part[len(key) + 1 :].strip('"')
    return None


def _build_dicts(meta: List[str]) -> Tuple[List[str], List[str]]:
    """(string dictionary, contig dictionary) from header meta lines, honoring
    explicit IDX= overrides. PASS is entry 0 of the string dictionary."""
    strings: Dict[int, str] = {0: "PASS"}
    nxt = 1
    contigs: Dict[int, str] = {}
    cnxt = 0
    seen = {"PASS"}
    for line in meta:
        if line.startswith(("##FILTER=", "##INFO=", "##FORMAT=")):
            name = _hdr_field(line, "ID")
            if name is None or name in seen:
                continue
            seen.add(name)
            idx = _hdr_field(line, "IDX")
            i = int(idx) if idx is not None else nxt
            strings[i] = name
            nxt = max(nxt, i + 1)
        elif line.startswith("##contig="):
            name = _hdr_field(line, "ID")
            if name is None:
                continue
            idx = _hdr_field(line, "IDX")
            i = int(idx) if idx is not None else cnxt
            contigs[i] = name
            cnxt = max(cnxt, i + 1)
    sd = [strings.get(i, f"?{i}") for i in range(max(strings) + 1)] if strings else []
    cd = [contigs.get(i, f"?{i}") for i in range(max(contigs) + 1)] if contigs else []
    return sd, cd


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class BcfReader:
    """Iterate VcfRecord from a BCF 2.2 path; header meta/samples retained."""

    def __init__(self, path: str):
        from denovo_kmer_tpu_torch.io.remote import open_binary

        self._fh = open_binary(path)  # local file or http(s)/s3/gs ranged stream
        self._r = BgzfReader(self._fh)
        magic = self._r.read(5)
        if magic != BCF_MAGIC:
            if magic[:3] == b"BCF":
                raise ValueError(
                    f"unsupported BCF version {magic[3]}.{magic[4]} (this reader "
                    f"implements BCF 2.2)")
            raise ValueError(f"not a BCF file: {path}")
        (l_text,) = struct.unpack("<I", self._r.readexactly(4))
        text = self._r.readexactly(l_text).rstrip(b"\x00").decode()
        self.meta = [ln for ln in text.splitlines() if ln.startswith("##")]
        self.samples: List[str] = []
        for ln in text.splitlines():
            if ln.startswith("#CHROM"):
                self.samples = ln.split("\t")[9:]
        self._strings, self._contigs = _build_dicts(self.meta)
        # INFO Flag-ness resolved once (the record loop must not rescan meta)
        self._flags = {
            _hdr_field(ln, "ID"): _hdr_field(ln, "Type") == "Flag"
            for ln in self.meta if ln.startswith("##INFO=")
        }

    def __iter__(self) -> Iterator[VcfRecord]:
        while True:
            head = self._r.read(8)
            if len(head) == 0:
                return
            if len(head) < 8:
                raise ValueError("truncated BCF record header")
            l_shared, l_indiv = struct.unpack("<II", head)
            body = self._r.readexactly(l_shared + l_indiv)
            yield self._record(body, l_shared)

    # -- decode one record ------------------------------------------------
    def _record(self, body: bytes, l_shared: int) -> VcfRecord:
        (rid, pos0, _rlen, qual_bits, n_ai, n_fs) = struct.unpack_from(
            "<iiiIII", body, 0)
        # QUAL missing is a specific NaN payload — compare bits (a float
        # round-trip would quieten the signaling NaN and lose it)
        qual = (None if qual_bits == _FLOAT_MISSING_BITS
                else struct.unpack("<f", struct.pack("<I", qual_bits))[0])
        n_info, n_allele = n_ai & 0xFFFF, n_ai >> 16
        n_sample, n_fmt = n_fs & 0xFFFFFF, n_fs >> 24
        c = _Cursor(body, 24)
        _, rec_id = c.typed_value()
        alleles = []
        for _ in range(n_allele):
            _, a = c.typed_value()
            alleles.append(a)
        _, filt = c.typed_value()
        if filt is None:
            filt_s = "."
        else:
            filt_s = ";".join(self._strings[i] for i in filt) or "."
        info: Dict[str, Union[str, bool]] = {}
        for _ in range(n_info):
            key = self._strings[c.typed_int()]
            kind, val = c.typed_value()
            if kind == "missing" or (kind == "int" and val == [1] and
                                     self._flags.get(key, False)):
                info[key] = True
            else:
                info[key] = _render(kind, val)
        fmt_keys: List[str] = []
        samples: List[Dict[str, str]] = [dict() for _ in range(n_sample)]
        c.p = l_shared
        for _ in range(n_fmt):
            key = self._strings[c.typed_int()]
            fmt_keys.append(key)
            atom, n = c._atom()
            for s in range(n_sample):
                if atom == _T_CHAR:
                    raw = c.d[c.p : c.p + n].decode("ascii")
                    c.p += n
                    samples[s][key] = raw.rstrip("\x00") or "."
                elif atom in (_T_INT8, _T_INT16, _T_INT32):
                    vals = c._ints(atom, n)
                    eov = _INT_EOV[atom]
                    vals = [v for v in vals if v != eov]
                    if key == "GT":
                        samples[s][key] = _gt_to_str(
                            vals, _INT_MISSING[atom]) or "."
                    else:
                        samples[s][key] = _render("int", [
                            None if v == _INT_MISSING[atom] else v
                            for v in vals]) or "."
                elif atom == _T_FLOAT:
                    raw = struct.unpack_from(f"<{n}I", c.d, c.p)
                    c.p += 4 * n
                    vals = [None if b == _FLOAT_MISSING_BITS else
                            struct.unpack("<f", struct.pack("<I", b))[0]
                            for b in raw if b != _FLOAT_EOV_BITS]
                    samples[s][key] = _render("float", vals) or "."
                elif atom == _T_MISSING:
                    samples[s][key] = "."
                else:
                    raise ValueError(f"BCF: FORMAT atom {atom} unsupported")
        chrom = (self._contigs[rid] if 0 <= rid < len(self._contigs)
                 else str(rid))
        ref = alleles[0] if alleles else "N"
        return VcfRecord(
            chrom=chrom, pos=pos0 + 1, id=rec_id or ".", ref=ref,
            alts=[a for a in alleles[1:]],
            qual=qual,
            filter=filt_s, info=info, format=fmt_keys,
            samples=samples if fmt_keys else [],
        )

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _render(kind: str, vals) -> str:
    if kind == "char":
        return vals
    parts = []
    for v in vals:
        if v is None:
            parts.append(".")
        elif kind == "float":
            parts.append(f"{v:g}")
        else:
            parts.append(str(v))
    return ",".join(parts)


def _gt_to_str(vals: List[int], missing: int) -> str:
    out = []
    for i, v in enumerate(vals):
        sep = "" if i == 0 else ("|" if v & 1 else "/")
        allele = "." if v == missing or (v >> 1) == 0 else str((v >> 1) - 1)
        out.append(sep + allele)
    return "".join(out)


def _gt_from_str(s: str) -> List[int]:
    vals = []
    phased = False
    tok = ""
    for ch in s + "/":  # sentinel separator flushes the last token
        if ch in "/|":
            if tok in (".", ""):
                a = 0
            else:
                try:
                    a = int(tok) + 1
                except ValueError:
                    raise ValueError(f"malformed GT {s!r}") from None
            vals.append((a << 1) | (1 if phased else 0))
            phased = ch == "|"
            tok = ""
        else:
            tok += ch
    return vals


def read_bcf_records(path: str) -> Iterator[VcfRecord]:
    with BcfReader(path) as r:
        yield from r


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def write_bcf(
    path: str,
    records: Sequence[VcfRecord],
    contigs: Sequence[Tuple[str, int]] = (),
    samples: Sequence[str] = (),
    extra_meta: Sequence[str] = (),
) -> None:
    """Write BCF 2.2 mirroring ``write_vcf``'s surface. Header dictionaries are
    derived from the records (FILTER/INFO/FORMAT keys typed as String unless
    boolean → Flag); contigs not listed are appended from record CHROMs."""
    records = list(records)  # scanned twice (dictionaries, then rows)
    contig_names = [c for c, _ in contigs]
    lengths = dict(contigs)
    info_keys: List[str] = []
    fmt_keys: List[str] = []
    filt_names: List[str] = []
    flag_keys = set()
    for r in records:
        if r.chrom not in lengths:
            contig_names.append(r.chrom)
            lengths[r.chrom] = 0
        for k, v in r.info.items():
            if k not in info_keys:
                info_keys.append(k)
            if v is True:
                flag_keys.add(k)
        for k in r.format:
            if k not in fmt_keys:
                fmt_keys.append(k)
        for fname in (r.filter or ".").split(";"):
            if fname not in (".", "", "PASS") and fname not in filt_names:
                filt_names.append(fname)
    # string dictionary: PASS=0, then FILTER/INFO/FORMAT names in header order
    sdict: List[str] = ["PASS"]
    meta = ["##fileformat=VCFv4.2"]
    for fname in filt_names:
        sdict.append(fname)
        meta.append(f'##FILTER=<ID={fname},Description="...",IDX={len(sdict)-1}>')
    for k in info_keys:
        if k not in sdict:
            sdict.append(k)
        typ = "Flag" if k in flag_keys else "String"
        num = "0" if k in flag_keys else "1"
        meta.append(f'##INFO=<ID={k},Number={num},Type={typ},Description="...",'
                    f'IDX={sdict.index(k)}>')
    for k in fmt_keys:
        if k not in sdict:
            sdict.append(k)
        meta.append(f'##FORMAT=<ID={k},Number=1,Type=String,Description="...",'
                    f'IDX={sdict.index(k)}>')
    for i, cname in enumerate(contig_names):
        ln = lengths.get(cname) or 0
        lenf = f",length={ln}" if ln else ""
        meta.append(f"##contig=<ID={cname}{lenf},IDX={i}>")
    meta.extend(extra_meta)
    hdr_cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
    if samples:
        hdr_cols.append("FORMAT")
        hdr_cols.extend(samples)
    text = ("\n".join(meta) + "\n" + "\t".join(hdr_cols) + "\n").encode() + b"\x00"
    sidx = {s: i for i, s in enumerate(sdict)}
    cidx = {c: i for i, c in enumerate(contig_names)}

    with open(path, "wb") as f, BgzfWriter(f) as w:
        w.write(BCF_MAGIC + struct.pack("<I", len(text)) + text)
        for r in records:
            shared = bytearray()
            alleles = [r.ref] + list(r.alts)
            rlen = max(len(r.ref), 1)
            if "END" in r.info and str(r.info["END"]).isdigit():
                rlen = max(rlen, int(str(r.info["END"])) - r.pos + 1)
            qual_bits = (_FLOAT_MISSING_BITS if r.qual is None else
                         struct.unpack("<I", struct.pack("<f", float(r.qual)))[0])
            n_ai = (len(alleles) << 16) | len(r.info)
            n_fs = (len(r.format) << 24) | len(r.samples)
            shared += struct.pack("<iiiIII", cidx[r.chrom], r.pos - 1, rlen,
                                  qual_bits, n_ai, n_fs)
            shared += _enc_string("" if r.id in (".", "") else r.id)
            for a in alleles:
                shared += _enc_string(a)
            fl = r.filter or "."
            if fl == ".":
                shared += _enc_typed_size(_T_MISSING, 0)
            else:
                shared += _enc_int_vector([sidx.get(x, 0) for x in fl.split(";")])
            for k, v in r.info.items():
                shared += _enc_typed_int(sidx[k])
                if v is True:
                    shared += _enc_typed_size(_T_MISSING, 0)
                else:
                    shared += _enc_string(str(v))
            indiv = bytearray()
            for k in r.format:
                indiv += _enc_typed_int(sidx[k])
                cells = [s.get(k, ".") for s in r.samples]
                if k == "GT":
                    gts = [_gt_from_str(c) for c in cells]
                    width = max(len(g) for g in gts) if gts else 1
                    flat = []
                    for g in gts:
                        flat.extend(g + [-127] * (width - len(g)))  # int8 EOV pad
                    if flat and max(flat) > 127:
                        raise ValueError(
                            "GT allele index > 62 needs int16 GT encoding")
                    indiv += _enc_typed_size(_T_INT8, width)
                    indiv += struct.pack(f"<{len(flat)}b", *flat)
                else:
                    width = max((len(c) for c in cells), default=1) or 1
                    indiv += _enc_typed_size(_T_CHAR, width)
                    for cstr in cells:
                        b = cstr.encode("ascii")
                        indiv += b + b"\x00" * (width - len(b))
            w.write(struct.pack("<II", len(shared), len(indiv)))
            w.write(bytes(shared) + bytes(indiv))
