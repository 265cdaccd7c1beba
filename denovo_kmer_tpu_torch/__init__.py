"""denovo_kmer_tpu_torch — the PyTorch/CUDA port of the de novo k-mer trio engine.

A second package beside the JAX reference ``denovo_kmer_tpu``. It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``denovo_kmer_tpu``; files keep the reference's
relative paths and names so each has a counterpart. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.

- ``io/``       host feeder: BGZF/BAM/FASTA decode, synthetic trios, device placement
- ``ops/``      device compute: extraction (``csrc/extract_kmers.cu``), tables, scoring,
  the fused trio call, the multipass spill (partition kernel ``csrc/radix_partition.cu``)
- ``parallel/`` the hash router (pass and shard buckets)
- ``oracle/``   scalar ground truth for SPEC_SEMANTICS.md
- ``pipeline``  end-to-end orchestration and candidate evidence; ``cohort`` multi-k sweeps
  and cohort mode; ``sites`` candidate-site grouping; ``cli`` the user entry point
"""

__version__ = "0.1.0"

from denovo_kmer_tpu_torch.config import EngineConfig

__all__ = ["EngineConfig", "__version__"]
