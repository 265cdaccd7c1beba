"""Table checkpoints and mid-pass resume.

The port of ``denovo_kmer_tpu/utils/checkpoint.py`` (the flat ``.npz`` half), in the same
file format, so a table written by either package loads in the other: one ``.npz`` with the
first ``n`` sorted keys (uint32 (n, W)) and counts (uint32 (n,)) and a JSON ``meta`` blob
(``FORMAT_VERSION`` 1) carrying the semantic config hash. A table loads only under the same
semantics (k, canonicalization, filters), because those knobs change the k-mer universe
(SPEC_SEMANTICS.md). Resume checkpoints add the BAM virtual-offset ``cursor`` and a ``done``
marker to the meta and are written atomically (temporary file + rename).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.table import KmerTable, table_from_numpy, table_to_numpy

FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    pass


def _savez(path: str, table: KmerTable, meta: dict) -> None:
    keys, counts, n = table_to_numpy(table)
    np.savez_compressed(
        path,
        keys=keys[:n],
        counts=counts[:n],
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def save_table(
    path: str,
    table: KmerTable,
    cfg: EngineConfig,
    source: Optional[str] = None,
    shard: Tuple[int, int] = (0, 1),
) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "config_hash": cfg.config_hash(),
        "k": cfg.k,
        "canonical": cfg.canonical,
        "n": int(table.n),
        "words": int(table.keys.shape[1]),
        "shard_index": shard[0],
        "shard_count": shard[1],
        "source": source,
    }
    _savez(path, table, meta)


def load_table(path: str, cfg: EngineConfig, capacity: Optional[int] = None,
               with_meta: bool = False, device=None):
    """Load a table checkpoint onto ``device`` (``None``: the card, as every entry point of
    the port) at ``capacity`` (default the config's); validates the semantic config hash.
    ``with_meta=True`` → (table, meta)."""
    from denovo_kmer_tpu_torch.pipeline import resolve_device

    device = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        keys = z["keys"]
        counts = z["counts"]
    if meta["format_version"] != FORMAT_VERSION:
        raise CheckpointError(f"unsupported checkpoint version {meta['format_version']}")
    if meta["config_hash"] != cfg.config_hash():
        raise CheckpointError(
            f"checkpoint semantics mismatch: saved under config {meta['config_hash']}, "
            f"current is {cfg.config_hash()} (k/canonical/filters must match)"
        )
    n = meta["n"]
    cap = capacity or cfg.table_capacity
    if n > cap:
        raise CheckpointError(f"checkpoint has {n} entries > capacity {cap}")
    W = keys.shape[1] if n else meta["words"]
    full_keys = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    full_counts = np.zeros((cap,), np.uint32)
    full_keys[:n] = keys
    full_counts[:n] = counts
    table = table_from_numpy(full_keys, full_counts, n, device)
    return (table, meta) if with_meta else table


def maybe_load_flat_table(path: str, cfg: EngineConfig, device=None):
    """→ KmerTable on ``device`` (``None``: the card) if ``path`` is a `count` .npz
    checkpoint, else None (treat as reads)."""
    if path.lower().endswith(".npz"):
        return load_table(path, cfg, device=device)
    return None


def table_meta(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["meta"]).decode())


def save_resume(path: str, table: KmerTable, cfg: EngineConfig,
                cursor: int, done: bool) -> None:
    """Mid-pass build checkpoint: the running table and the BAM virtual-offset cursor,
    written atomically so that a crash during the save keeps the previous one valid."""
    n = int(table.n)
    if n > table.keys.shape[0]:
        # a sticky overflow: the table dropped groups, and saving it would wedge every
        # later resume (meta n > saved rows)
        raise CheckpointError(
            f"table overflowed its capacity ({n} > {table.keys.shape[0]}); resume "
            f"checkpoint not written — raise --table-capacity and restart the build"
        )
    meta = {
        "format_version": FORMAT_VERSION,
        "config_hash": cfg.config_hash(),
        "n": n,
        "words": int(table.keys.shape[1]),
        "cursor": int(cursor),
        "done": bool(done),
    }
    tmp = path + ".tmp.npz"
    _savez(tmp, table, meta)
    os.replace(tmp, path)


def load_resume(path: str, cfg: EngineConfig, device=None):
    """→ (table on ``device``, cursor, done); validates the semantics hash and resolves the
    device as ``load_table`` does."""
    table, meta = load_table(path, cfg, with_meta=True, device=device)
    if "cursor" not in meta:
        raise CheckpointError(f"{path} is not a resume checkpoint")
    return table, int(meta["cursor"]), bool(meta["done"])
