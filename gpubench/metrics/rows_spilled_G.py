"""Rows a trio that the port appends to its per-pass stores (its ``rows_spilled`` tally, the
partition's valid rows, counted in ``ops/spill.store_append``), in billions."""

from gpubench.spans import per_trio
from gpubench.spill_work import spilled


def read(run):
    if not spilled(run):
        return None
    return per_trio(run, lambda m: m.tallies["rows_spilled"] / 1e9)
