"""Host-side 2-bit packing: read records → fixed-width batch arrays (numpy).

A copy of ``PackedReads``, ``padded_length``, ``pack_seqs``, ``_pack_codes``,
``pack_records`` and ``pack_records_bucketed`` from ``denovo_kmer_tpu/ops/pack.py``, with the
same layout.

Layout (per batch of B reads, padded length Lp = ceil(max_read_len/32)*32):
- ``words``  (B, Lp//16) uint32 — base j of read i sits in word j//16, bits 2*(j%16)..+1 (LSB-first)
- ``vwords`` (B, Lp//32) uint32 — validity bit j at bit j%32 of word j//32 (1 = valid ACGT base
  passing the quality policy; padding beyond the read length is 0)
- ``length`` (B,) int32 — read lengths (before padding)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig

#: byte → 2-bit code LUT; 255 = invalid
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for i, ch in enumerate(b"ACGT"):
    _CODE_LUT[ch] = i
for i, ch in enumerate(b"acgt"):
    _CODE_LUT[ch] = i


@dataclasses.dataclass
class PackedReads:
    words: np.ndarray  # (B, Lp//16) uint32
    vwords: np.ndarray  # (B, Lp//32) uint32
    length: np.ndarray  # (B,) int32
    n_reads: int  # actual reads in the batch (rest is padding)
    # True when every read's validity is exactly its length prefix (no Ns, no
    # quality-masked bases): then ``vwords`` is a pure function of ``length`` and the
    # host->device feed ships lengths (B*4 bytes) instead of vwords (B*Lp/8); the
    # extraction kernel tests ``p + k <= length`` instead.
    prefix_valid: bool = False

    @property
    def padded_len(self) -> int:
        return self.words.shape[1] * 16


def padded_length(max_read_len: int) -> int:
    return -(-max_read_len // 32) * 32


def pack_seqs(
    seqs: Sequence[str],
    cfg: EngineConfig,
    quals: Optional[Sequence[Optional[Sequence[int]]]] = None,
    batch_size: Optional[int] = None,
) -> PackedReads:
    """Pack sequences (already record-filtered) into one PackedReads batch: one flat byte
    buffer → one LUT lookup → one fancy-index placement."""
    Lp = padded_length(cfg.max_read_len)
    B = batch_size if batch_size is not None else len(seqs)
    nseq = len(seqs)
    if nseq > B:
        raise ValueError(f"batch overflow: {nseq} > {B}")
    codes = np.zeros((B, Lp), dtype=np.uint8)
    valid = np.zeros((B, Lp), dtype=bool)
    length = np.zeros(B, dtype=np.int32)
    if nseq:
        bufs = [s.encode("ascii", "replace")[: cfg.max_read_len] for s in seqs]
        lens = np.fromiter((len(b) for b in bufs), np.int64, nseq)
        flat = np.frombuffer(b"".join(bufs), np.uint8)
        c = _CODE_LUT[flat]
        ok = c != 255
        if cfg.min_base_quality > 0 and quals is not None:
            qparts = []
            for i, q in enumerate(quals[:nseq]):
                if q is None:
                    # no qualities for this read: no quality filtering
                    qparts.append(np.full(int(lens[i]), 0x7FFF, np.int32))
                    continue
                if len(q) < len(seqs[i]):
                    # same contract as the oracle (scalar.read_kmers): a malformed
                    # record errors, before any max_read_len truncation can mask it
                    raise ValueError(
                        f"quality string shorter than sequence ({len(q)} < "
                        f"{len(seqs[i])}) in read {i} of the batch — malformed "
                        f"input record"
                    )
                qparts.append(np.asarray(q[: int(lens[i])], dtype=np.int32))
            qflat = np.concatenate(qparts) if qparts else np.zeros(0, np.int32)
            ok = ok & (qflat >= cfg.min_base_quality)
        ends = np.cumsum(lens)
        rows = np.repeat(np.arange(nseq), lens)
        cols = np.arange(int(ends[-1])) - np.repeat(ends - lens, lens)
        codes[rows, cols] = np.where(ok, c, 0)
        valid[rows, cols] = ok
        length[:nseq] = lens
    return _pack_codes(codes, valid, length, nseq)


def _pack_codes(
    codes: np.ndarray, valid: np.ndarray, length: np.ndarray, n_reads: int
) -> PackedReads:
    B, Lp = codes.shape
    c = codes.astype(np.uint32).reshape(B, Lp // 16, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    words = np.bitwise_or.reduce(c << shifts, axis=2).astype(np.uint32)
    v = valid.astype(np.uint32).reshape(B, Lp // 32, 32)
    vshifts = np.arange(32, dtype=np.uint32)[None, None, :]
    vwords = np.bitwise_or.reduce(v << vshifts, axis=2).astype(np.uint32)
    # valid never extends past the length prefix, so equal POPULATION counts mean
    # validity == prefix exactly (one cheap reduce, no per-position compare)
    pv = bool(int(valid.sum()) == int(length.sum()))
    return PackedReads(words=words, vwords=vwords, length=length, n_reads=n_reads,
                       prefix_valid=pv)


def pack_records(
    records: Iterable,  # Iterable[BamRecord-like] with .seq/.qual/.flag
    cfg: EngineConfig,
) -> Iterator[PackedReads]:
    """Apply the record filter (SPEC_SEMANTICS §4) and yield fixed-size packed batches."""
    seqs: List[str] = []
    quals: List[Optional[Sequence[int]]] = []
    for rec in records:
        if rec.flag & cfg.filter_flag_mask:
            continue
        seqs.append(rec.seq)
        quals.append(rec.qual)
        if len(seqs) == cfg.batch_reads:
            yield pack_seqs(seqs, cfg, quals, batch_size=cfg.batch_reads)
            seqs, quals = [], []
    if seqs:
        yield pack_seqs(seqs, cfg, quals, batch_size=cfg.batch_reads)


def pack_records_bucketed(
    records: Iterable,
    cfg: EngineConfig,
) -> Iterator[Tuple[int, PackedReads]]:
    """Length-bucketed packing (cfg.read_len_buckets): yield (bucket_width, PackedReads) with
    each read packed at the smallest bucket that holds it, so extraction runs
    width-proportional work per bucket instead of padding every read to max_read_len. Reads
    longer than the last bucket truncate to it (as plain packing does). Remainder batches
    flush per bucket at the end of the stream."""
    buckets = tuple(cfg.read_len_buckets or (cfg.max_read_len,))
    cfgs = {w: dataclasses.replace(cfg, max_read_len=w, read_len_buckets=None)
            for w in buckets}
    pend: Dict[int, Tuple[List[str], List[Optional[Sequence[int]]]]] = {
        w: ([], []) for w in buckets
    }
    for rec in records:
        if rec.flag & cfg.filter_flag_mask:
            continue
        L = len(rec.seq)
        w = next((b for b in buckets if L <= b), buckets[-1])
        seqs, quals = pend[w]
        seqs.append(rec.seq)
        quals.append(rec.qual)
        if len(seqs) == cfg.batch_reads:
            yield w, pack_seqs(seqs, cfgs[w], quals, batch_size=cfg.batch_reads)
            pend[w] = ([], [])
    for w in buckets:
        seqs, quals = pend[w]
        if seqs:
            yield w, pack_seqs(seqs, cfgs[w], quals, batch_size=cfg.batch_reads)
