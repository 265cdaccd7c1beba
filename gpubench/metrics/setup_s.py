"""Seconds from the process's start to the window's: imports, CUDA start, the kernels'
loading (and building, in a checkout's first run), the reads, the warm-up trio."""


def read(run):
    return run.setup_s
