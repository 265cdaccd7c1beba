"""One process of N for the port's multi-process harness: joins a gloo process group on
127.0.0.1, builds a mesh over every rank's local CPU devices, runs
``denovo_kmer_tpu_torch.parallel.multihost.run_trio_multihost`` and writes its report.

    python tests/torch_multihost_worker.py <proc_id> <n_procs> <port> <trio_dir> <out_tsv> \
        [--devices-per-proc D] [--mesh RxT] [--ckpt-dir DIR] [--fault sample:proc:batch] \
        [--feed stripe|range] [--passes N] [--spill-rows N] [--require-ici-local]

Every rank writes ``<out_tsv>.rank<proc_id>`` (the reports must agree on every rank) and rank
0 also ``<out_tsv>``. Imports nothing of JAX.
"""

import argparse
import os
import sys
import warnings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("proc_id", type=int)
    ap.add_argument("n_procs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("trio_dir")
    ap.add_argument("out_tsv")
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--mesh", default="2x4")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fault", default=None, help="sample:proc_id:after_batches")
    ap.add_argument("--feed", default="stripe", choices=("stripe", "range"))
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--spill-rows", type=int, default=None)
    ap.add_argument("--require-ici-local", action="store_true")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective waits for a dead peer")
    ap.add_argument("--collectives", action="store_true",
                    help="hold all_to_all / psum / all_gather on the multi-process mesh to "
                         "the same collectives on a one-process mesh, then exit")
    args = ap.parse_args()

    import torch

    torch.set_num_threads(1)
    from denovo_kmer_tpu_torch.config import EngineConfig
    from denovo_kmer_tpu_torch.oracle.scalar import decode_kmer
    from denovo_kmer_tpu_torch.parallel.distributed import initialize_distributed
    from denovo_kmer_tpu_torch.parallel.mesh import make_mesh
    from denovo_kmer_tpu_torch.parallel.multihost import run_trio_multihost

    initialize_distributed(f"127.0.0.1:{args.port}", args.n_procs, args.proc_id,
                           backend="gloo", timeout=args.timeout)
    r, t = (int(x) for x in args.mesh.lower().split("x"))
    if args.collectives:
        _check_collectives(args, (r, t))
        return 0
    cfg = EngineConfig(k=args.k, max_read_len=64, batch_reads=64, table_capacity=1 << 13,
                       accum_batches=2, mesh_shape=(r, t))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = make_mesh((r, t), [torch.device("cpu")] * args.devices_per_proc)
    for w in caught:
        print(f"mesh warning: {w.message}", file=sys.stderr)
    fault = None
    if args.fault:
        s, p, b = args.fault.split(":")
        fault = (s, int(p), int(b))

    cands = run_trio_multihost(
        os.path.join(args.trio_dir, "mom.bam"),
        os.path.join(args.trio_dir, "dad.bam"),
        os.path.join(args.trio_dir, "child.bam"),
        cfg,
        checkpoint_dir=args.ckpt_dir,
        fault=fault,
        feed=args.feed,
        n_passes=args.passes,
        require_ici_local=args.require_ici_local,
        spill_rows=args.spill_rows,
        mesh=mesh,
    )
    text = "#kmer\tchild_count\tmom_count\tdad_count\n" + "".join(
        f"{decode_kmer(v, cfg.k)}\t{c}\t{m}\t{d}\n" for v, c, m, d in cands)
    with open(f"{args.out_tsv}.rank{args.proc_id}", "w") as f:
        f.write(text)
    if args.proc_id == 0:
        with open(args.out_tsv, "w") as f:
            f.write(text)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _check_collectives(args, shape):
    """Every rank draws the same per-cell tensors from one seed; the collectives of the
    multi-process mesh, on this rank's cells, must equal those of a one-process mesh over
    every cell: the same values on the same shards."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from denovo_kmer_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(shape, [torch.device("cpu")] * args.devices_per_proc)
    R, T = shape
    one = M.Mesh(mesh.devices)  # the same grid, every cell in this process
    rng = np.random.default_rng(7)
    cases = {
        "route": [[torch.from_numpy(rng.integers(0, 2**31, (T * 5, 2))) for _ in range(T)]
                  for _ in range(R)],
        "mask": [[torch.from_numpy(rng.random(T * 3) < 0.5) for _ in range(T)]
                 for _ in range(R)],
        "empty": [[torch.zeros((0, 2), dtype=torch.int64) for _ in range(T)]
                  for _ in range(R)],
        "ovf": [[torch.tensor(int(rng.integers(0, 100))) for _ in range(T)] for _ in range(R)],
        "table": [[torch.from_numpy(rng.integers(0, 2**31, (6, 1))) for _ in range(T)]
                  for _ in range(R)],
    }

    def local(full):
        return [[x if mesh.is_local(i, j) else None for j, x in enumerate(row)]
                for i, row in enumerate(full)]

    checks = [(M.all_to_all, name, ()) for name in ("route", "mask", "empty")]
    checks += [(M.psum, "ovf", (axes,)) for axes in
               ((M.AXIS_READS, M.AXIS_TABLE), (M.AXIS_READS,), (M.AXIS_TABLE,))]
    checks += [(M.all_gather, name, ()) for name in ("table", "ovf")]
    for fn, name, extra in checks:
        got = fn(mesh, local(cases[name]), *extra)
        want = fn(one, cases[name], *extra)
        for i, j in mesh.local_cells():
            if not torch.equal(got[i][j], want[i][j]):
                raise AssertionError(f"{fn.__name__} {name} {extra}: cell {(i, j)} differs")
        if any(got[i][j] is not None for i in range(R) for j in range(T)
               if not mesh.is_local(i, j)):
            raise AssertionError(f"{fn.__name__}: a cell of another rank was filled")
    with open(f"{args.out_tsv}.rank{args.proc_id}", "w") as f:
        f.write(f"collectives ok on {len(mesh.local_cells())} cells\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
