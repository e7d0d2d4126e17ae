"""Evaluation entry point (PyTorch): load a config and a checkpoint, run a split,
print per-utterance HYP/REF and the aggregate loss/CER/WER.

Counterpart of ``gtn_applications_tpu/test.py``.  Runs on CUDA unless
``--disable_cuda`` asks for the CPU.  Under a process group (``train.py``'s
rendezvous flags or torchrun's environment) every rank evaluates the whole
split, as JAX's multi-host evaluation does: each decodes its own batches
and ``Meters.sync`` sums the counts over the ``'data'`` ranks, so the
rates and the mean loss are the one-process run's (and each sample counts
once a data rank).  With ``optim.seq_parallel`` dividing the world, the
ranks of a ``'seq'`` line split each batch's time axis as ``train.py``
does (JAX's ``test.py`` shards it so too) and gather the logits before
decoding.

    python -m gtn_applications_tpu_torch.test --config CONFIG.json \
        --checkpoint_path DIR [--split test] [--disable_cuda]
"""

import argparse
import json
import logging

import torch.distributed as dist

from . import utils
from .train import (
    add_distributed_args, criterion_to_device, dataset_kwargs, evaluate,
    init_distributed, load_experiment, make_eval_step, make_mesh, select_device,
)


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
    add_distributed_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args


def run_test(args):
    device = select_device(getattr(args, "disable_cuda", False))
    with open(args.config, "r") as fid:
        config = json.load(fid)

    dataset, preprocessor, criterion, model, _ = load_experiment(config)
    ds = dataset.Dataset(
        config["data"].get("data_path"), preprocessor, split=args.split,
        **dataset_kwargs(config),
    )
    loader = utils.data_loader(ds, config)

    template = {"model": model.state_dict(), "criterion": dict(criterion.params),
                "epoch": 0, "num_updates": 0}
    state = utils.load_checkpoint(args.checkpoint_path, load_last=args.load_last,
                                  template=template)
    model.load_state_dict(state["model"])
    model.to(device)
    criterion_to_device(criterion, device, state["criterion"])
    criterion.eval()

    def report(predictions, targets):
        for p, t in zip(predictions, targets):
            print(f"HYP: {preprocessor.tokens_to_text(p)}")
            print(f"REF: {preprocessor.to_text(t)}")
            print("=" * 80)

    mesh = make_mesh(config["optim"].get("seq_parallel", 1))
    meters = evaluate(
        model, criterion, loader, preprocessor,
        make_eval_step(model, criterion, mesh.group("seq")), device,
        config["optim"].get("use_input_lengths", False), report, mesh,
    )
    print(
        "Loss {:.3f}, CER {:.3f}, WER {:.3f}".format(
            meters.avg_loss, meters.cer, meters.wer
        )
    )
    return meters


def main(argv=None):
    args = parse_args(argv)
    created = init_distributed(args, select_device(args.disable_cuda))
    try:
        return run_test(args)
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
