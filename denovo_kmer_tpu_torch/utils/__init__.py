"""Host utilities of the port: metrics, checkpoints, the device choice, the CUDA build."""

from denovo_kmer_tpu_torch.utils.metrics import Metrics, StageTimer

__all__ = ["Metrics", "StageTimer"]
