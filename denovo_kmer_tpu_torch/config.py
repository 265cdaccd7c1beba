"""EngineConfig — the single frozen config object for the whole engine.

A copy of ``denovo_kmer_tpu/config.py`` with the same fields, defaults and validation, so a
config built for one package means the same run in the other. Every semantic knob pinned in
``SPEC_SEMANTICS.md`` lives here. The config hash participates in checkpoint keys and
golden-test IDs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

# BAM flag bits (SAM spec)
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

#: Default record filter: skip unmapped/secondary/QC-fail/dup/supplementary (SPEC_SEMANTICS §4).
DEFAULT_FILTER_MASK = (
    FLAG_UNMAP | FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP | FLAG_SUPPLEMENTARY
)


def words_per_kmer(k: int) -> int:
    """Number of uint32 words holding a 2k-bit k-mer value (SPEC_SEMANTICS §2.1)."""
    if not 1 <= k <= 63:
        raise ValueError(f"k must be in [1, 63], got {k}")
    return -(-2 * k // 32)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen engine configuration. See SPEC_SEMANTICS.md for the meaning of each knob."""

    # --- semantics (SPEC_SEMANTICS §§1-6) ---
    k: int = 31
    canonical: bool = True
    filter_flag_mask: int = DEFAULT_FILTER_MASK
    min_base_quality: int = 0
    tau_parent: int = 0
    min_child_count: int = 2

    # --- batching / static shapes ---
    #: reads per device batch (per data-parallel shard)
    batch_reads: int = 4096
    #: padded read length (bases); reads longer than this are truncated (config error in
    #: practice — pick >= max read length of the input)
    max_read_len: int = 160
    #: OPTIONAL length bucketing: ascending padded widths, last == max_read_len; each read is
    #: packed and extracted at the smallest width that holds it (pipeline.py)
    read_len_buckets: Optional[Tuple[int, ...]] = None

    # --- table sizing ---
    #: capacity (slots) of a parental/child k-mer table per shard
    table_capacity: int = 1 << 20
    #: batches appended to the raw staging buffer between LSM flushes (ops/stream.py);
    #: staging memory = accum_batches * batch_reads * windows_per_read * (4*words+1) B
    #: (and the flush sort needs a few times that transiently)
    accum_batches: int = 8

    # --- mesh / sharding ---
    #: mesh axis sizes: (data-parallel 'reads' axis, table-shard 'table' axis)
    mesh_shape: Tuple[int, int] = (1, 1)
    #: per-(src,dst) all-to-all routing capacity factor over the even split
    route_capacity_factor: float = 1.25

    # --- kernels ---
    #: extraction layout of the JAX package: "fast", "fast_t" or "pallas" (all
    #: bit-identical there). In the port all three values run the same hand-written CUDA
    #: kernel (csrc/extract_kmers.cu); the field stays so that configs match.
    extractor: str = "fast"

    # --- I/O ---
    #: reference FASTA for CRAM inputs (reference-based slices); not a semantic knob
    reference_fasta: "str | None" = None

    # --- misc ---
    #: emit structured JSON metrics
    json_metrics: bool = False

    @property
    def words(self) -> int:
        return words_per_kmer(self.k)

    @property
    def windows_per_read(self) -> int:
        return max(self.max_read_len - self.k + 1, 0)

    def config_hash(self) -> str:
        """Stable hash over the *semantic* knobs only (not batching/mesh), for checkpoint keys
        and golden-test IDs."""
        sem = dict(
            k=self.k,
            canonical=self.canonical,
            filter_flag_mask=self.filter_flag_mask,
            min_base_quality=self.min_base_quality,
            tau_parent=self.tau_parent,
            min_child_count=self.min_child_count,
        )
        blob = json.dumps(sem, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def __post_init__(self):
        words_per_kmer(self.k)  # validates k
        if self.max_read_len < self.k:
            raise ValueError(
                f"max_read_len ({self.max_read_len}) must be >= k ({self.k})"
            )
        if self.mesh_shape[0] < 1 or self.mesh_shape[1] < 1:
            raise ValueError(f"bad mesh_shape {self.mesh_shape}")
        if not 0 <= self.tau_parent < 0xFFFF:
            # the scored path packs saturated parental counts into 16-bit fields
            raise ValueError(
                f"tau_parent ({self.tau_parent}) must be in [0, 65534]"
            )
        if self.min_child_count < 1:
            raise ValueError(
                f"min_child_count ({self.min_child_count}) must be >= 1"
            )
        if self.extractor not in ("fast", "fast_t", "pallas"):
            raise ValueError(f"unknown extractor {self.extractor!r}")
        if self.accum_batches < 1:
            raise ValueError("accum_batches must be >= 1")
        if self.read_len_buckets is not None:
            b = tuple(self.read_len_buckets)
            if not b or list(b) != sorted(set(b)):
                raise ValueError(f"read_len_buckets must be ascending unique: {b}")
            if b[-1] != self.max_read_len:
                raise ValueError(
                    f"last bucket ({b[-1]}) must equal max_read_len "
                    f"({self.max_read_len})"
                )
            if b[0] < self.k:
                raise ValueError(f"bucket {b[0]} < k ({self.k})")
