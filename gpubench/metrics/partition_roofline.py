"""The partition step's share of its bound: the bytes its rows need
(``spill_work.partition_bytes``: the staged rows of ``rows_partitioned`` read once, the rows
of ``rows_spilled`` written once) at the card's memory rate, over ``partition_device_s``, in
percent."""

from gpubench import roofline
from gpubench.spans import per_trio
from gpubench.spill_work import partition_bytes, spilled, words


def read(run):
    if not spilled(run):
        return None
    W = words(run)
    seconds = per_trio(run, lambda m: m.span_seconds("spill.partition", device=True))
    nbytes = per_trio(run, lambda m: partition_bytes(
        m.tallies["rows_partitioned"], m.tallies["rows_spilled"], W))
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / seconds if seconds else None
