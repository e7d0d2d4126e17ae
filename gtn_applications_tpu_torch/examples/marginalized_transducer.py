#!/usr/bin/env python
"""Marginalized wordpiece Transducer end to end on the synthetic dataset.

Twin of the repository's ``examples/marginalized_transducer.py``: grapheme
targets and a wordpiece token inventory without a lexicon make the
Transducer marginalize over every wordpiece decomposition of each target
(the Differentiable WFST paper's word_decomps setup): the
transitions-free Transducer, optional blank, no repeats, TDS2d, 25 epochs,
train CER every fourth step, through the port's ``train.py``.  Runs on
CUDA unless ``--cpu`` asks for the CPU.

    python -m gtn_applications_tpu_torch.examples.marginalized_transducer \\
        [--cpu] [--epochs N] [--workdir DIR]
"""

import argparse
import json
import os
import tempfile

from .. import train as train_mod

# wordpieces over the synthetic alphabet (a-j): every character, the word
# separator and common bigrams
PIECES = [c for c in "abcdefghij▁"] + ["ab", "ba", "cd", "dc", "ef", "gh", "ij"]


def make_config(workdir, epochs=25):
    """The example's config, its pieces file written into ``workdir``."""
    tokens_path = os.path.join(workdir, "pieces.txt")
    with open(tokens_path, "w") as fid:
        fid.write("\n".join(PIECES))
    return {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 16,
                 "tokens": tokens_path, "prepend_wordsep": True},
        "criterion_type": "transducer",
        "criterion": {"blank": "optional", "allow_repeats": False},
        "model_type": "tds2d",
        "model": {"depth": 2,
                  "tds_groups": [
                      {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
                      {"channels": 8, "num_blocks": 1, "stride": [2, 1]}],
                  "kernel_size": [3, 5], "dropout": 0.0},
        "optim": {"batch_size": 8, "epochs": epochs, "learning_rate": 0.05,
                  "step_size": 15, "max_grad_norm": 5, "metrics_interval": 4},
    }


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU.")
    parser.add_argument("--epochs", type=int, default=25)
    parser.add_argument("--workdir", default=None,
                        help="Config, pieces and checkpoints (default: a new "
                        "temporary directory)")
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns the train history."""
    args = parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="marg_")
    cfg = os.path.join(workdir, "config.json")
    with open(cfg, "w") as fid:
        json.dump(make_config(workdir, args.epochs), fid)
    device = ["--disable_cuda"] if args.cpu else []
    _, history = train_mod.train(train_mod.parse_args(
        ["--config", cfg, "--checkpoint_path", workdir] + device))
    return history


if __name__ == "__main__":
    main()
