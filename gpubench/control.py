"""The correctness check's control, at a cell's own size: the reference put in the
program's place with k-mers counted by a fingerprint one 32-bit key word narrower than
their value (``reference.control_bits``), held to the same exact comparison.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3

For each seed it prints the numbers compared beside their limits and whether the control
came out correct (it must not). The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from gpubench import harness

    cell = harness.load_cell(args.workload, False)
    eargs = harness.engine_args(cell.config, cell.traffic, args.device)
    from denovo_kmer_tpu_torch import cli

    cfg = cli._cfg_from_args(eargs)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        exact = harness.reference_answers(cell, seed, eargs, cfg, args.device)
        control = harness.reference_answers(cell, seed, eargs, cfg, args.device,
                                            fingerprint=True)
        numbers, failed = harness.compare(exact, [control])
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": failed == 0,
                          "seconds": time.perf_counter() - t0, "check": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
