"""Host seconds a trio in the port's ``report`` spans (``pipeline._trio_result``: the
candidate tuples and the TSV of every k)."""

from gpubench.spans import per_trio


def read(run):
    return per_trio(run, lambda m: m.span_seconds("report"))
