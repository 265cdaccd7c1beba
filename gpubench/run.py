"""Run one benchmark cell once and print its result as the last line of standard output.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The run needs as many CUDA cards
as the cell names; without them it exits 2 and prints no result. It exits 3, and prints no
result, if JAX or the JAX package was imported. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics. Each number the check
compared is printed beside its limit on the last lines of standard error and under the
result's last key, ``check``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "denovo_kmer_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names among ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    import torch  # noqa: F401

    t1 = time.perf_counter()
    from gpubench import harness
    from gpubench.roofline import nvidia_smi

    print(f"gpubench: set-up: python start to main {t0 - T_START:.3f} s, import torch "
          f"{t1 - t0:.3f} s, gpubench {time.perf_counter() - t1:.3f} s", file=sys.stderr)

    cell = harness.load_cell(args.workload, bool(args.trace))
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    harness.log(f"card: {nvidia_smi('name,power.limit')}")
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
