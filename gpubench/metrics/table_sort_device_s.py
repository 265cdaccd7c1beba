"""Device seconds a trio inside the port's ``table.sort`` spans: the sort(s) of
``ops/table._sorted_groups``, which every flush, seed and fused call makes, by their CUDA
events."""

from gpubench.spans import per_trio


def read(run):
    return per_trio(run, lambda m: m.span_seconds("table.sort", device=True))
