"""Readings that the correctness limits are set from.

    python3 perfbench/calibrate.py --workload NAME --seeds 1 2 3 \
        [--faults half_batch altered_token] [--control] [--float64] [--out FILE]

For each seed, on the cell's own corpus, batches and sizes: the program's
numbers against the plain reference (a train cell's first three steps, an
eval cell's pass over the corpus), the control's (the reference computed
with TF32, in the program's place) and each planted fault's
(``faults.py``).  With ``--float64`` (train cells) the reference is run
again in float64, and the program and the float32 reference are each
read against it: how far rounding alone moves each number.  One JSON line a seed and variant, to ``--out`` and to
standard output.  Needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, cell, corpus, task, seed, device):
    """The program's readings of one seed, as a run takes them."""
    prog = bench.Program(cell, corpus, task, seed, device)
    if cell.mode == "train":
        r = bench.first_steps(bench.TrainLoop(prog), prog)
        return r, bench.program_train_readings(r, task)
    _, batches = bench.EvalLoop(prog).epoch()
    r = {"w0": prog.w0, "batches": [(c, float(loss), preds) for c, loss, preds in batches]}
    return r, r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import bench, faults
    from perfbench import traffic as traffic_mod

    from gtn_applications_tpu_torch import train as ptrain

    cell = bench.Cell(args.workload, ROOT)
    device = ptrain.select_device()
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.time()
        corpus = traffic_mod.make_corpus(cell.traffic, seed, cell.root)
        task = cell.reference.Task(cell.cfg, corpus.chars, cell.root)
        raw, prog = readings(bench, cell, corpus, task, seed, device)
        ref = bench.reference(cell, task, corpus, raw, device)
        rows = [("program", bench.numbers(cell, task, prog, ref))]
        if args.control:
            tf = bench.reference(cell, task, corpus, raw, device, tf32=True)
            rows.append(("control_tf32", bench.numbers(cell, task, bench.as_program(cell, task, tf),
                                                       ref)))
        if args.float64 and cell.mode == "train":
            f64 = bench.reference(cell, task, corpus, raw, device, dtype=torch.float64)
            rows.append(("program_vs_f64", bench.numbers(cell, task, prog, f64)))
            rows.append(("ref32_vs_f64", bench.numbers(cell, task, bench.as_program(cell, task, ref),
                                                       f64)))
            del f64
        for name in args.faults:
            with faults.FAULTS[name]():
                _, faulty = readings(bench, cell, corpus, task, seed, device)
            rows.append((name, bench.numbers(cell, task, faulty, ref)))
        for variant, nums in rows:
            line = json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                               "seconds": round(time.time() - t0, 2), **nums})
            print(line, flush=True)
            if out:
                print(line, file=out, flush=True)
        del raw, prog, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
