"""Run one cell of the benchmark of ``gtn_applications_tpu_torch``.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the result as the last line of standard output, and each
number the check compared beside its limit as the last lines of standard
error.  Exits non-zero, printing no result, without CUDA, with fewer
cards than the cell asks for, or if a module of JAX or of the JAX package
is loaded once the window has closed.
"""

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import bench

    cell = bench.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"{args.workload} needs {cell.workload['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    from gtn_applications_tpu_torch import train as ptrain

    device = ptrain.select_device()
    result = bench.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                       log=lambda text: print(text, file=sys.stderr, flush=True))
    banned = bench.banned_modules()
    if banned:
        print(f"loaded modules of {', '.join(banned)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
