"""Run one cell of the benchmark of commet_tpu_torch once, on the CUDA card
of this machine, and print its result as the last line of standard output.

    python3 commet_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. Exit codes: 0 a result was printed (its
``correct`` may be false), 2 no CUDA card or fewer than the cell asks for,
3 JAX or the JAX package was loaded in this process, 1 any other failure.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches, at fixed paths inside the checkout (the
# program's own build directory, commet_tpu_torch/_build/, is one too)
CACHES = {"TRITON_CACHE_DIR": os.path.join(ROOT, ".bench_cache", "triton"),
          "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, ".bench_cache",
                                               "torch_extensions")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = path
    sys.path.insert(0, ROOT)
    from commet_bench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except harness.Forbidden as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
