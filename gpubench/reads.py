"""The benchmark's reads: a trio made on the device from a seed, packed in the port's layout.

``ReadSpec`` (a traffic file's ``reads``) describes the trio: a uniform random genome; two
haplotypes a parent, each with substitution SNVs at ``het_rate``; the child is mom's
haplotype 0 with ``dnms`` de novo SNVs at sites where no parental haplotype varies, plus
dad's haplotype 0. Each sample has ``coverage`` x ``genome_len`` / ``read_len`` reads, each
from one of its two haplotypes, a share ``reverse_share`` of them reverse-complemented, with
substitution errors at ``err_rate`` and Ns at ``n_rate`` a base.

Every random stream is its own ``torch.Generator`` seeded from (seed, what it draws), and
the reads come in chunks of ``CHUNK_READS``, each with its own stream, so that the
reference can make any chunk again after the window without keeping the reads.

``pack_codes`` and ``pack_sample`` give the port's ``PackedReads`` layout (``ops/pack.py``;
the harness imports the dataclass, nothing else): ``words`` (B, Lp/16) uint32, base j at
bits 2(j%16) of word j//16; ``vwords`` (B, Lp/32) uint32, bit j set where base j is A, C, G
or T; ``length`` (B,) int32; codes of invalid bases 0; ``prefix_valid`` where a batch holds
no N.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, List, Optional

import numpy as np
import torch

#: reads a generation chunk (a reference block)
CHUNK_READS = 1 << 20
N_CODE = 4  # a base that is not A, C, G or T
SAMPLES = ("mom", "dad", "child")


@dataclasses.dataclass(frozen=True)
class ReadSpec:
    genome_len: int
    coverage: int
    read_len: int
    het_rate: float
    dnms: int
    err_rate: float
    n_rate: float
    reverse_share: float

    @property
    def reads(self) -> int:
        return -(-self.coverage * self.genome_len // self.read_len)

    @property
    def chunks(self) -> int:
        return -(-self.reads // CHUNK_READS)


def generator(seed: int, *what, device) -> torch.Generator:
    """A generator on ``device`` for the stream ``what`` of run ``seed``."""
    digest = hashlib.sha256(repr((int(seed), *what)).encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _substitute(codes: torch.Tensor, mask: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """``codes`` with a different base where ``mask`` is set."""
    alt = torch.randint(1, 4, codes.shape, generator=g, device=codes.device, dtype=torch.uint8)
    return torch.where(mask, (codes + alt) % 4, codes)


def haplotypes(spec: ReadSpec, seed: int, device) -> dict:
    """{sample: (haplotype 0, haplotype 1)} as uint8 code tensors on ``device``."""
    L = spec.genome_len
    genome = torch.randint(0, 4, (L,), generator=generator(seed, "genome", device=device),
                           device=device, dtype=torch.uint8)
    varies = torch.zeros(L, dtype=torch.bool, device=device)
    haps = {}
    for parent in ("mom", "dad"):
        pair = []
        for h in (0, 1):
            g = generator(seed, "snv", parent, h, device=device)
            mask = torch.rand(L, generator=g, device=device) < spec.het_rate
            pair.append(_substitute(genome, mask, g))
            varies |= mask
        haps[parent] = tuple(pair)
    g = generator(seed, "dnm", device=device)
    sites = torch.randint(0, L, (4 * spec.dnms + 64,), generator=g, device=device).unique()
    sites = sites[~varies[sites]]
    if sites.numel() < spec.dnms:
        raise ValueError(f"the genome of {L} bases has room for {sites.numel()} de novo "
                         f"sites, not {spec.dnms}")
    sites = sites[torch.randperm(sites.numel(), generator=g, device=device)[:spec.dnms]]
    child0 = haps["mom"][0].clone()
    child0[sites] = _substitute(genome[sites], torch.ones_like(sites, dtype=torch.bool), g)
    haps["child"] = (child0, haps["dad"][0])
    return haps


def chunk_codes(spec: ReadSpec, seed: int, sample: str, chunk: int, haps) -> torch.Tensor:
    """Chunk ``chunk`` of ``sample``'s reads: (n, read_len) uint8 codes in read orientation,
    ``N_CODE`` where a base is N."""
    dev = haps[0].device
    g = generator(seed, "reads", sample, chunk, device=dev)
    n = min(CHUNK_READS, spec.reads - chunk * CHUNK_READS)
    RL = spec.read_len
    which = torch.randint(0, 2, (n,), generator=g, device=dev)
    pos = torch.randint(0, spec.genome_len - RL + 1, (n,), generator=g, device=dev)
    codes = torch.empty((n, RL), dtype=torch.uint8, device=dev)
    for h, hap in enumerate(haps):
        sel = which == h
        codes[sel] = hap.unfold(0, RL, 1)[pos[sel]]
    codes = _substitute(codes, torch.rand((n, RL), generator=g, device=dev) < spec.err_rate, g)
    codes[torch.rand((n, RL), generator=g, device=dev) < spec.n_rate] = N_CODE
    rev = torch.rand(n, generator=g, device=dev) < spec.reverse_share
    rc = torch.where(codes == N_CODE, codes, 3 - codes).flip(1)
    return torch.where(rev[:, None], rc, codes)


def sample_chunks(spec: ReadSpec, seed: int, sample: str, haps) -> Iterator[torch.Tensor]:
    for c in range(spec.chunks):
        yield chunk_codes(spec, seed, sample, c, haps)


def padded_length(max_read_len: int) -> int:
    return -(-max_read_len // 32) * 32


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_codes(codes: torch.Tensor, max_read_len: int):
    """(words, vwords, length, has_n) of reads given as uint8 codes: the port's layout at
    ``max_read_len`` (reads longer than it are cut to it), on the codes' device."""
    codes = codes[:, :max_read_len]
    n, RL = codes.shape
    Lp = padded_length(max_read_len)
    valid = torch.zeros((n, Lp), dtype=torch.bool, device=codes.device)
    valid[:, :RL] = codes != N_CODE
    c = torch.zeros((n, Lp), dtype=torch.int64, device=codes.device)
    c[:, :RL] = codes.to(torch.int64)
    c = torch.where(valid, c, 0)
    words = (c.view(n, Lp // 16, 16) << (2 * torch.arange(16, device=codes.device))).sum(-1)
    bits = valid.to(torch.int64).view(n, Lp // 32, 32) << torch.arange(32, device=codes.device)
    vwords = bits.sum(-1)
    length = torch.full((n,), RL, dtype=torch.int32, device=codes.device)
    return _u32_bits(words), _u32_bits(vwords), length, ~valid[:, :RL].all(1)


@dataclasses.dataclass
class SampleReads:
    """One sample's packed batches in host memory, as the port's feeder would hand them."""

    name: str
    n_reads: int
    batches: list  # of PackedReads
    valid_windows: dict  # {k: windows with no N}


def pack_sample(spec: ReadSpec, seed: int, name: str, haps, batch_reads: int,
                max_read_len: int, ks, packed_reads_cls) -> SampleReads:
    """Make ``name``'s reads on the haplotypes' device and pack them into host batches of
    ``batch_reads`` (``packed_reads_cls`` is the port's ``PackedReads``)."""
    n = spec.reads
    B = batch_reads
    nb = -(-n // B)
    Lw = padded_length(max_read_len) // 16
    words = np.zeros((nb * B, Lw), np.uint32)
    vwords = np.zeros((nb * B, Lw // 2), np.uint32)
    length = np.zeros(nb * B, np.int32)
    has_n = torch.zeros(nb * B, dtype=torch.bool)
    windows = {k: 0 for k in ks}
    row = 0
    for codes in sample_chunks(spec, seed, name, haps):
        w, v, ln, hn = pack_codes(codes, max_read_len)
        r = slice(row, row + codes.shape[0])
        torch.from_numpy(words[r].view(np.int32)).copy_(w)
        torch.from_numpy(vwords[r].view(np.int32)).copy_(v)
        torch.from_numpy(length[r]).copy_(ln)
        has_n[r] = hn.cpu()
        for k in ks:
            windows[k] += int(window_ok(codes[:, :max_read_len], k).sum())
        row += codes.shape[0]
    batch_has_n = has_n.view(nb, B).any(1).tolist()
    batches = [packed_reads_cls(words=words[i * B:(i + 1) * B],
                                vwords=vwords[i * B:(i + 1) * B],
                                length=length[i * B:(i + 1) * B],
                                n_reads=min(B, n - i * B), prefix_valid=not batch_has_n[i])
               for i in range(nb)]
    return SampleReads(name, n, batches, windows)


def window_ok(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L - k + 1) bool: the windows of k bases with no N."""
    is_n = (codes == N_CODE).to(torch.int32)
    csum = torch.nn.functional.pad(is_n.cumsum(1), (1, 0))
    return (csum[:, k:] - csum[:, :-k]) == 0


def make_trio(spec: ReadSpec, seed: int, device, batch_reads: int, max_read_len: int, ks,
              packed_reads_cls) -> List[SampleReads]:
    """The three samples' host batches, made on ``device``; nothing stays on it."""
    haps = haplotypes(spec, seed, device)
    return [pack_sample(spec, seed, s, haps[s], batch_reads, max_read_len, ks,
                        packed_reads_cls) for s in SAMPLES]


def first_batches(sample: SampleReads, n: int) -> SampleReads:
    """The first ``n`` batches of a sample (the warm-up's reads)."""
    batches = sample.batches[:n]
    return SampleReads(sample.name, sum(b.n_reads for b in batches), batches, {})


def spill_rows(samples: List[SampleReads], k: int, passes: int, slack: Optional[float]):
    """A device store's rows a pass: ``slack`` x the largest sample's valid windows /
    ``passes``, rounded up (None without a slack)."""
    if slack is None:
        return None
    return int(np.ceil(slack * max(s.valid_windows[k] for s in samples) / passes))
