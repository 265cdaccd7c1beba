"""The table steps' share of their bound: the bytes their data needs (each input table's
filled rows and the staged rows read once, the output's filled rows written once, each at
its own row width) at the card's memory rate, over their device seconds, in percent."""

from gpubench import roofline


def read(run):
    if run.probe is None or not run.probe.table or not run.probe.table_s:
        return None
    return 100.0 * run.probe.table_bytes / roofline.HBM_BYTES_PER_S / run.probe.table_s
