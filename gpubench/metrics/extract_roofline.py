"""The ingest step's share of its bound: the least time its batches' bytes and integer
operations take at the card's peaks (``roofline.extraction_bytes_ops``), over the device time
of everything launched inside the "extract" spans, in percent."""


def read(run):
    if run.probe is None or run.trace is None:
        return None
    bound, spent = run.probe.extract_bound_s, run.trace["extract_device_s"]
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
