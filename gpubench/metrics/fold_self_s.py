"""Host seconds a trio in the port's ``fold`` spans (``pipeline._fold_stream``) outside their
child spans (the feed's waits, the ingest steps and the flushes): the dispatch loop's own
per-batch Python."""

from gpubench.spans import per_trio


def read(run):
    return per_trio(run, lambda m: m.span_seconds("fold", own=True))
