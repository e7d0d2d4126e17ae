"""Evaluation entry point (PyTorch): load a config and a checkpoint, run a split,
print per-utterance HYP/REF and the aggregate loss/CER/WER.

Counterpart of ``gtn_applications_tpu/test.py``.  Runs on CUDA unless
``--disable_cuda`` asks for the CPU.

    python -m gtn_applications_tpu_torch.test --config CONFIG.json \
        --checkpoint_path DIR [--split test] [--disable_cuda]
"""

import argparse
import json
import logging

from . import utils
from .train import evaluate, load_experiment, make_eval_step, select_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a model.")
    parser.add_argument("--config", type=str, help="JSON configuration file.")
    parser.add_argument("--checkpoint_path", default="/tmp/", type=str)
    parser.add_argument(
        "--load_last", action="store_true",
        help="Load the last saved model instead of the best",
    )
    parser.add_argument(
        "--split",
        default="test",
        choices=["train", "validation", "test"],
    )
    parser.add_argument(
        "--disable_cuda", action="store_true", help="Run on the CPU."
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args


def run_test(args):
    device = select_device(getattr(args, "disable_cuda", False))
    with open(args.config, "r") as fid:
        config = json.load(fid)

    dataset, preprocessor, criterion, model, _ = load_experiment(config)
    ds = dataset.Dataset(
        config["data"].get("data_path"), preprocessor, split=args.split
    )
    loader = utils.data_loader(ds, config)

    state = utils.load_checkpoint(args.checkpoint_path, load_last=args.load_last)
    model.load_state_dict(state["model"])
    model.to(device)

    def report(predictions, targets):
        for p, t in zip(predictions, targets):
            print(f"HYP: {preprocessor.tokens_to_text(p)}")
            print(f"REF: {preprocessor.to_text(t)}")
            print("=" * 80)

    meters = evaluate(
        model, criterion, loader, preprocessor, make_eval_step(model, criterion),
        device, config["optim"].get("use_input_lengths", False), report,
    )
    print(
        "Loss {:.3f}, CER {:.3f}, WER {:.3f}".format(
            meters.avg_loss, meters.cer, meters.wer
        )
    )
    return meters


def main(argv=None):
    run_test(parse_args(argv))


if __name__ == "__main__":
    main()
