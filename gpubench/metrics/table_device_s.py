"""Device seconds a trio in the table steps (``flush``, ``flush_score``,
``seed_score_table``), by CUDA events around each call."""


def read(run):
    if run.probe is None or not run.probe.table:
        return None
    return run.probe.table_s / len(run.trios)
