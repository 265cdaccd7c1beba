"""The most device memory the port held at once in the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 1e9
