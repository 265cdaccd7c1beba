"""Device seconds a trio in the port's ``spill.fold`` spans: the per-pass folds of the stored
rows into the parents' tables and the child's scoring table (``ops/spill.count_pass_from_store``,
``score_pass_from_store``), with the flushes inside them, by their CUDA events."""

from gpubench.spans import per_trio
from gpubench.spill_work import spilled


def read(run):
    if not spilled(run):
        return None
    return per_trio(run, lambda m: m.span_seconds("spill.fold", device=True))
