"""Distribution layer: the device mesh, hash-sharded tables, all-to-all probe routing and
runs over several processes (``torch.distributed``).

The names below are resolved on first use: the ops import ``parallel.router`` and the
engine imports the ops, so importing them here would be a cycle, and importing this
package starts no process group and touches no card.
"""

import importlib

_EXPORTS = {
    "make_mesh": "denovo_kmer_tpu_torch.parallel.mesh",
    "owner_of": "denovo_kmer_tpu_torch.parallel.router",
    "bucketize": "denovo_kmer_tpu_torch.parallel.router",
    "route_capacity": "denovo_kmer_tpu_torch.parallel.router",
    "ShardedKmerEngine": "denovo_kmer_tpu_torch.parallel.sharded_table",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
