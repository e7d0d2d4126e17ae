"""Train one of ``chip_smoke.py``'s main paths (``convtrans`` by default)
several times and run its first-batch checks on each trained model.

    python -m gtn_applications_tpu_torch.scripts.repeat_convtrans_checks \
        [--trials N] [--path convtrans | transducer_wordpieces | ...]

Run from the root of a checkout, on a machine with a GPU.  The card's
weight gradients are not deterministic, so each training ends at other
weights and the first batch's logits differ from run to run; the path's
checks (``chip_smoke.MAIN_BATCH_CHECKS``; for ``convtrans`` the CTC loss
and logit gradient and ``ConvTransduce1D`` on the card against the CPU
and against float64, for the word decompositions the dense pair against
float64) are held on each.  It prints every check's line, one verdict a
trial, and the card's name and power limit; it exits 1 if a trial
failed.
"""

import argparse
import sys
import time
import traceback


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trials", type=int, default=8)
    parser.add_argument("--path", default="convtrans")
    args = parser.parse_args(argv)

    import torch

    import chip_smoke as cs

    t0 = time.perf_counter()
    card = cs.phase_device(torch)
    dev = torch.device("cuda")
    cs.phase_build()
    cs.wordpiece_inventories()
    config = cs.main_path_config(args.path)
    check = cs.MAIN_BATCH_CHECKS[args.path]
    failed = 0
    for trial in range(args.trials):
        model = cs.phase_main_path(torch, dev, args.path, config)["model"]
        try:
            check(torch, dev, model, config)
            print(f"trial {trial}: passed", flush=True)
        except AssertionError:
            failed += 1
            traceback.print_exc()
            print(f"trial {trial}: FAILED", flush=True)
    print(f"[{card}] {args.trials - failed} of {args.trials} trials passed, "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
