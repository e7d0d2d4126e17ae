"""How far ``chip_smoke.py``'s sequence-parallel leg (b) lies from one
process, beside float32 rounding alone.

    python -m gtn_applications_tpu_torch.scripts.seq_rounding [--device cpu] [--threads 8]

Run from the root of a checkout.  The ctc path's full-width model
(``configs/iamdb/tds2d.json``, dropout 0) takes ``chip_smoke.DP_STEPS``
steps on the smoke's batches (padded to a width that 8 divides) three
ways: in one process, in one process with each batch's rows reversed (the
same function, its sums in another order: float32 rounding alone), and on
two gloo ranks of a 1 x 2 ``('data', 'seq')`` grid, each holding half of
the frames.  It prints, as JSON, each way's loss relative errors against
one process at every step and its update distance (the parameters'
distance from one process's over one process's update) after the first
and the last step, with the device and, on a card, its name and power
limit.  ``--device cpu`` runs on the host (about half a minute at full
width on 8 cores).
"""

import argparse
import json
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--threads", type=int, default=None,
                        help="intra-op threads of the one-process runs (torch's default)")
    args = parser.parse_args(argv)

    import torch

    import chip_smoke as cs
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    device = "cuda:0" if args.device == "cuda" else args.device
    if args.threads:
        torch.set_num_threads(args.threads)
    _, dev = cs.seq_rank_device(device)
    config = cs.dp_config()
    batches = [(cs.pad_width(x, cs.SEQ_WIDTH_MULTIPLE), t) for x, t in cs.dp_batches(config)]
    reversed_rows = [(x[::-1].copy(), t[::-1]) for x, t in batches]
    one = cs.dp_steps(torch, dev, config, batches)
    other = cs.dp_steps(torch, dev, config, reversed_rows)
    ranks = pmesh.spawn(cs.seq_dp_rank, cs.SEQ_RANKS_B, args=(device, config, batches),
                        backend="gloo", timeout=3000)
    init = {k: v.numpy() for k, v in train_mod.load_experiment(
        config, torch.Generator().manual_seed(config["seed"]))[3].state_dict().items()}

    def against_one(run):
        return {"loss_rel": [abs(a - b) / abs(b) for a, b in zip(run["losses"], one["losses"])],
                "first_update_distance": cs.update_distance(run["first"], one["first"], init),
                "update_distance": cs.update_distance(run["params"], one["params"], init)}

    out = {"device": device, "steps": cs.DP_STEPS, "width": int(batches[0][0].shape[2]),
           "losses": one["losses"], "reversed_rows": against_one(other),
           "seq_ranks": [against_one(r) for r in ranks],
           "seconds": time.perf_counter() - t0}
    if dev.type == "cuda":
        out["card"] = utils.card_name_and_power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
