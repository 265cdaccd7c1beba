"""Device seconds a trio in the port's ``spill.partition`` spans (``ops/spill.partition_window``:
the pass ids, the partition kernel and the assembly of the pass blocks), by their CUDA
events."""

from gpubench.spans import per_trio
from gpubench.spill_work import spilled


def read(run):
    if not spilled(run):
        return None
    return per_trio(run, lambda m: m.span_seconds("spill.partition", device=True))
