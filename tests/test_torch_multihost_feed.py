"""The port's multi-process trio with the other feeds and the multipass, in 2 real OS
processes over gloo on tests/test_multihost.py's trio and config: the virtual-offset range
feed, the 2-pass re-decode multipass and the 2-pass single-decode spill through the per-shard
device store each give, on every rank, the JAX package's single-process run_trio report.
The invalid combinations raise JAX's ValueErrors before any process group is needed."""

import pytest

from _torch_multihost import CFG, jax_report, reports, run_ok, write_trio


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = write_trio(tmp_path_factory.mktemp("torch_mh_feed_trio"))
    return d, jax_report(d)


@pytest.mark.parametrize("extra", [
    ("--feed", "range"),
    ("--passes", "2"),
    ("--passes", "2", "--spill-rows", "4096"),
    ("--passes", "3", "--spill-rows", "4096", "--feed", "range"),
], ids=["range_feed", "multipass_2", "spill_2", "spill_3_range"])
def test_multiprocess_feeds_match_jax_single_host(trio, tmp_path, extra):
    d, golden = trio
    out = str(tmp_path / "mh.tsv")
    run_ok(2, d, out, extra)
    assert reports(out, 2) == [golden, golden]


@pytest.mark.parametrize("kwargs,msg", [
    (dict(n_passes=2, checkpoint_dir="ck"), "checkpoint_dir does not compose"),
    (dict(spill_rows=10), "spill_rows requires n_passes >= 2"),
    (dict(n_passes=2, spill_rows=10, fault=("mom", 0, 1)), "composes with neither"),
])
def test_invalid_combinations_raise_as_jax(kwargs, msg):
    from denovo_kmer_tpu.parallel.multihost import run_trio_multihost as jax_run
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.parallel.multihost import run_trio_multihost

    for fn in (jax_run, run_trio_multihost):
        cfg = EngineConfig(**CFG) if fn is run_trio_multihost else None
        with pytest.raises(ValueError, match=msg):
            fn("m", "d", "c", cfg, **kwargs)
