#!/usr/bin/env python
"""End-to-end quickstart of the port on the synthetic glyph dataset.

Twin of the repository's ``examples/quickstart.py``: trains the TDS2d +
CTC pipeline (``configs/synthetic/tds2d_ctc.json``'s model, 30 epochs,
train CER every fourth step) through the port's ``train.py``, then
evaluates the best checkpoint on the test split through its ``test.py``.
Runs on CUDA unless ``--cpu`` asks for the CPU.

    python -m gtn_applications_tpu_torch.examples.quickstart [--cpu] \\
        [--epochs N] [--workdir DIR]
"""

import argparse
import json
import tempfile

from .. import test as test_mod
from .. import train as train_mod

CONFIG = {
    "seed": 0,
    "data": {"dataset": "synthetic", "num_features": 16},
    "model_type": "tds2d",
    "model": {
        "depth": 2,
        "tds_groups": [
            {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
            {"channels": 8, "num_blocks": 1, "stride": [2, 1]},
        ],
        "kernel_size": [3, 5],
        "dropout": 0.0,
    },
    "criterion_type": "ctc",
    "optim": {
        "batch_size": 8,
        "epochs": 30,
        "learning_rate": 0.02,
        "step_size": 20,
        "max_grad_norm": 5,
        "metrics_interval": 4,
    },
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU.")
    parser.add_argument("--epochs", type=int, default=CONFIG["optim"]["epochs"])
    parser.add_argument("--workdir", default=None,
                        help="Config and checkpoints (default: a new temporary directory)")
    return parser.parse_args(argv)


def main(argv=None):
    """Train, then test; returns (train history, test meters)."""
    args = parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="quickstart_")
    config = json.loads(json.dumps(CONFIG))
    config["optim"]["epochs"] = args.epochs
    config_path = f"{workdir}/config.json"
    with open(config_path, "w") as fid:
        json.dump(config, fid)
    device = ["--disable_cuda"] if args.cpu else []

    print(f"Training into {workdir} ...")
    _, history = train_mod.train(train_mod.parse_args(
        ["--config", config_path, "--checkpoint_path", workdir] + device))
    print("Evaluating the best checkpoint on the test split ...")
    meters = test_mod.run_test(test_mod.parse_args(
        ["--config", config_path, "--checkpoint_path", workdir, "--split", "test"] + device))
    return history, meters


if __name__ == "__main__":
    main()
