"""Device seconds a trio in the candidate call (``fused_call_full``, or
``call_from_score``), by CUDA events around each call."""


def read(run):
    if run.probe is None or not run.probe.calls:
        return None
    return run.probe.call_s / len(run.trios)
