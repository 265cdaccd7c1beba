"""Reads of the three samples over the trios the window ran, a second of the window, in
millions; a read counts once however many lanes fold it."""


def read(run):
    if not run.trios:
        return None
    return sum(t.reads for t in run.trios) / run.window_s / 1e6
