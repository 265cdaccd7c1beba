"""Rows a trio that the port's table steps sort (its ``rows_sorted`` tally, counted in
``ops/table._sorted_groups``), in billions."""

from gpubench.spans import per_trio


def read(run):
    return per_trio(run, lambda m: m.tallies.get("rows_sorted", 0) / 1e9)
