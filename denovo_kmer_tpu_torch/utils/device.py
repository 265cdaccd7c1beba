"""The device an entry point runs on: the card unless the caller names the CPU.

A leaf module, so that ``ops``, ``io`` and ``utils`` can resolve a device without importing
the pipeline. ``pipeline.resolve_device`` is this function.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: the port never carries
    on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
