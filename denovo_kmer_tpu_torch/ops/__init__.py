"""Device compute ops of the port:

- ``pack``      host: BAM records → 2-bit packed uint32 word tensors + validity bitmasks
- ``extract``   device: packed words → canonical multi-word k-mers (the CUDA kernel
                ``csrc/extract_kmers.cu`` on the card; ``extract_fast`` is its standalone
                entry)
- ``table``     device: sorted k-mer table — build / merge / binary-search probe
- ``table_merge`` device: merge of two sorted unique row sets into a table (the CUDA kernel
                ``csrc/table_merge.cu`` on the card), the table steps' fold
- ``trio``      device: de novo candidate rule + compaction
"""

from denovo_kmer_tpu_torch.ops.extract import extract_canonical_kmers
from denovo_kmer_tpu_torch.ops.pack import PackedReads, pack_records, pack_seqs
from denovo_kmer_tpu_torch.ops.table import (
    KmerTable,
    build_table,
    empty_table,
    merge_tables,
    probe_table,
)
from denovo_kmer_tpu_torch.ops.trio import candidate_flags

__all__ = [
    "PackedReads",
    "pack_records",
    "pack_seqs",
    "extract_canonical_kmers",
    "KmerTable",
    "build_table",
    "merge_tables",
    "probe_table",
    "empty_table",
    "candidate_flags",
]
