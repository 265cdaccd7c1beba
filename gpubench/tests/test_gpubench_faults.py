"""A whole run with the timed path broken underneath must come out not correct, once for
each fault a trio call can have (it runs on one card, so it has no exchange to leave out)."""

import pytest

from gpubench import harness
from gpubench.tests.conftest import tiny_cell


def _state_unchanged(pipeline, monkeypatch):
    """A flush hands back the table it was given: the staged rows are dropped."""
    real = pipeline.flush

    def flush(acc, table):
        real(acc, table)
        return acc._replace(fill=0), table

    monkeypatch.setattr(pipeline, "flush", flush)


def _half_batch(pipeline, monkeypatch):
    """The ingest step extracts half of each batch's reads."""
    real = pipeline._extract_append

    def extract(acc, words, vwords, lengths, *a):
        h = words.shape[0] // 2
        return real(acc, words[:h], None if vwords is None else vwords[:h],
                    None if lengths is None else lengths[:h], *a)

    monkeypatch.setattr(pipeline, "_extract_append", extract)


def _answer_altered(pipeline, monkeypatch):
    """The call adds one to the first candidate's child count."""
    real = pipeline.fused_call_full

    def call(*a, **kw):
        keys, cc, mc, dc, n_unique, n_child = real(*a, **kw)
        cc = cc.copy()
        cc[0] += 1
        return keys, cc, mc, dc, n_unique, n_child

    monkeypatch.setattr(pipeline, "fused_call_full", call)


@pytest.mark.parametrize("fault,caught_by", [
    (_state_unchanged, "mom_n_off"), (_half_batch, "mom_n_off"),
    (_answer_altered, "report_rows_off")])
@pytest.mark.parametrize("entry,flags", [("pipeline.run_trio", ("-k", "31")),
                                         ("cohort.run_trio_multi_k", ("--ks", "15,21,31,41"))])
def test_a_broken_step_makes_the_run_not_correct(monkeypatch, fault, caught_by, entry, flags):
    """Each fault is caught at every k, where the control is blind too (k = 15, 41)."""
    from denovo_kmer_tpu_torch import pipeline

    fault(pipeline, monkeypatch)
    out = harness.run_cell(tiny_cell(entry, flags), 5, 0.2, False, "cpu")
    assert out["correct"] is False and out["failed"] == out["attempted"] >= 1
    ks = [int(k) for k in flags[1].split(",")]
    assert all(out["check"][f"k{k}_{caught_by}"][0] > 0 for k in ks)


def test_the_same_runs_unbroken_are_correct():
    for entry, flags in (("pipeline.run_trio", ("-k", "31")),
                         ("cohort.run_trio_multi_k", ("--ks", "15,21,31,41"))):
        out = harness.run_cell(tiny_cell(entry, flags), 5, 0.2, False, "cpu")
        assert out["correct"] is True
