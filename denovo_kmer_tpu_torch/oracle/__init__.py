"""Scalar oracle: the normative, deliberately slow implementation of SPEC_SEMANTICS.md, a
copy of the JAX package's. Every device path of the port is held against it."""

from denovo_kmer_tpu_torch.oracle.scalar import (
    canonical_value,
    count_reads,
    decode_kmer,
    encode_base,
    encode_kmer,
    kmer_value_to_words,
    read_kmers,
    revcomp_value,
    trio_candidates,
    words_to_kmer_value,
)

__all__ = [
    "encode_base",
    "encode_kmer",
    "decode_kmer",
    "revcomp_value",
    "canonical_value",
    "read_kmers",
    "count_reads",
    "trio_candidates",
    "kmer_value_to_words",
    "words_to_kmer_value",
]
