"""Seconds a trio that the port's dispatch thread waited on its feed (``Metrics``
``feed_wait``, from ``io/prefetch.py``'s consumer starvation), averaged over the trios."""


def read(run):
    waits = [t.metrics.seconds["feed_wait"] for t in run.trios
             if "feed_wait" in t.metrics.seconds]
    if not waits:
        return None
    return sum(waits) / len(run.trios)
