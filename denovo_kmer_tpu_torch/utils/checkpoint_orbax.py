"""Orbax-layout table checkpoints, written and read through TensorStore alone.

Port of ``denovo_kmer_tpu/utils/checkpoint_orbax.py``. The JAX package saves a table with
``orbax.checkpoint.StandardCheckpointer``: a directory holding the arrays ``keys``,
``counts`` and ``n`` as zarr v2 arrays (zstd) in an OCDBT key-value store, orbax's JSON files
(``_METADATA``, ``_CHECKPOINT_METADATA``, ``array_metadatas/process_0``) and the package's
``denovo_kmer_meta.json`` (format version, semantic config hash, shapes). orbax imports jax,
which the port never does, so this module writes and reads the same directory with
``tensorstore`` (which imports no jax): a directory either package writes loads in the
other. Same semantics-hash validation as the npz path.

Engine-layout tables (``ShardedKmerEngine.save_table(..., backend="orbax")``) are the JAX
engine's global arrays, keys (R, T, C, W), counts (R, T, C), n (R, T), chunked one shard a
chunk as orbax writes them; a single-device table is keys (C, W), counts (C,), n (). Across
processes the engine gathers the table to the writing rank, as the npz path does.

``tensorstore`` is needed for either direction; without it both raise ``ImportError``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np

from denovo_kmer_tpu_torch.config import EngineConfig
from denovo_kmer_tpu_torch.ops.table import KmerTable, table_from_numpy, table_to_numpy
from denovo_kmer_tpu_torch.utils.checkpoint import CheckpointError
from denovo_kmer_tpu_torch.utils.device import resolve_device

FORMAT_VERSION = 1
NAMES = ("counts", "keys", "n")  # orbax's tree order
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "the orbax table directory needs the 'tensorstore' package, which is not "
            "installed; use backend='npz'") from e
    return tensorstore


def _spec(path: str, name: str) -> dict:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{path}/", "path": f"{name}/"}}


def _arrays(table) -> dict:
    """Host arrays of a port ``KmerTable`` or of the engine's ``engine_arrays`` dict."""
    if isinstance(table, KmerTable):
        keys, counts, n = table_to_numpy(table)
        return {"keys": keys, "counts": counts, "n": np.array(n, np.int32)}
    return {"keys": np.asarray(table["keys"], np.uint32),
            "counts": np.asarray(table["counts"], np.uint32),
            "n": np.asarray(table["n"], np.int32)}


def save_table_orbax(path: str, table, cfg: EngineConfig, source: Optional[str] = None,
                     write: bool = True) -> None:
    """Persist a table as an orbax checkpoint directory at ``path`` (replaced if it
    exists, as orbax's ``force=True``). ``table``: a single-device ``KmerTable`` or the
    engine-layout arrays (``ShardedKmerEngine.engine_arrays``); ``write=False`` writes
    nothing (the other ranks of a multi-process save)."""
    ts = _tensorstore()
    if not write:
        return
    arrs = _arrays(table)
    sharded = arrs["keys"].ndim == 4
    chunks = {name: ((1, 1) + a.shape[2:] if sharded else a.shape)
              for name, a in arrs.items()}
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(os.path.join(path, "array_metadatas"))
    for name in NAMES:
        a = np.array(arrs[name], order="C")  # ascontiguousarray would make n 1-d
        store = ts.open(
            dict(_spec(path, name),
                 metadata={"shape": list(a.shape), "chunks": list(chunks[name]),
                           "dtype": a.dtype.str, "compressor": {"id": "zstd", "level": 1},
                           "fill_value": None, "filters": None, "order": "C",
                           "dimension_separator": "."}),
            create=True).result()
        store.write(a).result()
    tree = {f"('{name}',)": {"key_metadata": [{"key": name, "key_type": 2}],
                             "value_metadata": {"value_type": "jax.Array",
                                                "skip_deserialize": False,
                                                "write_shape": list(chunks[name])}}
            for name in NAMES}
    now = time.time_ns()
    files = {
        "_METADATA": {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True,
                      "custom_metadata": None},
        "_CHECKPOINT_METADATA": {"item_handlers": _HANDLER, "metrics": {},
                                 "performance_metrics": {}, "init_timestamp_nsecs": now,
                                 "commit_timestamp_nsecs": now, "custom_metadata": {}},
        os.path.join("array_metadatas", "process_0"): {"array_metadatas": [
            {"array_metadata": {"param_name": name, "write_shape": list(chunks[name]),
                                "chunk_shape": list(chunks[name]), "ext_metadata": None}}
            for name in NAMES]},
        "denovo_kmer_meta.json": {
            "format_version": FORMAT_VERSION, "config_hash": cfg.config_hash(), "k": cfg.k,
            "source": source,
            "shape": {name: list(arrs[name].shape) for name in ("keys", "counts", "n")}},
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)


def load_arrays_orbax(path: str, cfg: EngineConfig) -> dict:
    """The host arrays ``{"keys", "counts", "n"}`` of an orbax table directory, after the
    format and semantics-hash checks."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, "denovo_kmer_meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise CheckpointError(f"unsupported orbax table version {meta['format_version']}")
    if meta["config_hash"] != cfg.config_hash():
        raise CheckpointError(
            f"checkpoint semantics mismatch: saved under config {meta['config_hash']}, "
            f"current is {cfg.config_hash()}"
        )
    return {name: np.asarray(ts.open(_spec(path, name)).result().read().result())
            for name in ("keys", "counts", "n")}


def load_table_orbax(path: str, cfg: EngineConfig, device=None,
                     like: Optional[KmerTable] = None) -> KmerTable:
    """Restore a single-device table on ``device`` (default the card), or on the device of
    ``like``, a table, when it is given. An engine-layout directory loads through
    ``ShardedKmerEngine.load_table(..., backend="orbax")``."""
    if like is not None:
        device = like.keys.device
    arrs = load_arrays_orbax(path, cfg)
    if arrs["keys"].ndim != 2:
        raise CheckpointError(
            f"{path} holds an engine-layout table (keys {arrs['keys'].shape}); load it with "
            "ShardedKmerEngine.load_table(path, backend='orbax')")
    return table_from_numpy(arrs["keys"], arrs["counts"], int(arrs["n"]),
                            device=resolve_device(device))
