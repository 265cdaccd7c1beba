"""The port's own spans and tallies (``denovo_kmer_tpu_torch/utils/metrics.py``), as the
harness keeps them: the port's ``Metrics`` of each trio of the window. They are recorded
only while a profiler runs, so an untraced run, or a port without spans, has none to read."""


def per_trio(run, read_one):
    """The mean over the window's trios of ``read_one(metrics)``; None where a trio's
    Metrics recorded no span."""
    found = [t.metrics for t in run.trios]
    if not found or not all(getattr(m, "spans", None) for m in found):
        return None
    return sum(read_one(m) for m in found) / len(found)
