"""Fixtures of the harness's tests: tiny cells that run on the CPU, and the card where a
test needs one (decided here, when a test asks for it)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_READS = {"genome_len": 20000, "coverage": 10, "read_len": 151, "het_rate": 0.001,
              "dnms": 10, "err_rate": 0.002, "n_rate": 0.002, "reverse_share": 0.5}
TINY_FLAGS = ["--max-read-len", "160", "--batch-reads", "256", "--accum-batches", "2"]


def tiny_cell(entry="pipeline.run_trio", flags=("-k", "31"), route=None, reads=None):
    from gpubench import harness

    config = {"entry": entry, "flags": [*flags, *TINY_FLAGS]}
    traffic = {"reads": dict(reads or TINY_READS),
               "route": route or {"table_capacity": 1 << 16, "passes": 1}}
    return harness.Cell("tiny", config, traffic, [])


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
