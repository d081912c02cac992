"""The control of each cell's comparison, run through the benchmark's own
run and check: the plain reference put in the program's place with one
guarantee of the configuration broken (a window a member when keya alone
is set, for the search; the index built without the reads that hold an N,
for the plane build), at the cell's own size, on several seeds. Each run
has to come out not correct.

    python3 commet_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

Prints one JSON line a seed: ``correct``, ``attempted``, ``failed`` and the
numbers compared beside their limits. Needs a CUDA card; the benchmark's
own runs do not run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from commet_bench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.time()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "checks": r["checks"],
                          "seconds": time.time() - t0,
                          "device": r["device"]["kind"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
