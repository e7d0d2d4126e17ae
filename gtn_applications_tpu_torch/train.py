"""Training entry point (PyTorch, one device).

Counterpart of ``gtn_applications_tpu/train.py`` for one CUDA device: JSON
experiment configs, the epoch loop with SGD and a halving learning-rate
schedule, global-norm gradient clipping, per-epoch train and validation
CER/WER, best-checkpoint tracking and restore.  The device mesh, the fused
multi-step executables, orbax checkpoints and the profiler are not ported
yet (ROADMAP queue A item 12).

Runs on CUDA unless ``--disable_cuda`` asks for the CPU; without that flag
and without a GPU it raises.  TF32 is switched off for cuDNN convolutions
and cuBLAS matmuls: the reference numbers are fp32.

    python -m gtn_applications_tpu_torch.train --config CONFIG.json \
        --checkpoint_path DIR [--disable_cuda]
"""

import argparse
import json
import logging
import time

import numpy as np
import torch

from . import utils


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a handwriting / speech recognition model."
    )
    parser.add_argument("--config", type=str, help="JSON configuration file.")
    parser.add_argument(
        "--disable_cuda", action="store_true", help="Run on the CPU."
    )
    parser.add_argument("--restore", action="store_true")
    parser.add_argument("--last_epoch", type=int, default=0)
    parser.add_argument("--checkpoint_path", default="/tmp/", type=str)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args


def select_device(disable_cuda=False):
    """The device an entry point runs on; full fp32 math on CUDA."""
    if disable_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --disable_cuda to run on the CPU"
        )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def clip_global_norm(grads, max_norm):
    """Scale ``grads`` in place by min(1, max_norm / max(||grads||, 1e-6))."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads


def make_train_step(model, criterion, lr_model, lr_crit, max_grad_norm):
    """The train step: forward, loss, backward, clip, SGD.

    ``step(inputs, prepared, generator, lr_scale, input_lengths=None)``
    updates the parameters of ``model`` (and of the criterion, if it has
    any) in place with ``p -= lr * lr_scale * g`` and returns the detached
    (loss, outputs).  ``generator`` draws the dropout masks.
    ``input_lengths`` (None for reference parity: the reference scores the
    zero-padded frames) masks padded frames out of the lattice."""
    model_params = list(model.parameters())
    crit_params = list(criterion.params.values())

    def step(inputs, prepared, generator, lr_scale, input_lengths=None):
        params = model_params + crit_params
        for p in params:
            p.grad = None
        outputs = model(inputs, train=True, generator=generator)
        loss = criterion.loss(criterion.params, outputs, prepared, input_lengths)
        loss.backward()
        grads = [p.grad for p in params]
        if max_grad_norm is not None:
            clip_global_norm(grads, max_grad_norm)
        with torch.no_grad():
            for p, g in zip(model_params, grads):
                p.sub_(lr_model * lr_scale * g)
            for p, g in zip(crit_params, grads[len(model_params):]):
                p.sub_(lr_crit * lr_scale * g)
        return loss.detach(), outputs.detach()

    return step


def make_eval_step(model, criterion):
    @torch.no_grad()
    def step(inputs, prepared, input_lengths=None):
        outputs = model(inputs)
        loss = criterion.loss(criterion.params, outputs, prepared, input_lengths)
        return loss, outputs

    return step


def output_lengths(model, widths):
    """Map input widths to encoder output frame counts via the model's
    total time stride."""
    stride = getattr(model, "time_stride", 1)
    return torch.as_tensor(-(-np.asarray(widths) // stride), dtype=torch.int32)


def _to_device(inputs, prepared, device):
    inputs = torch.from_numpy(inputs).to(device)
    prepared = tuple(p.to(device) for p in prepared)
    return inputs, prepared


def evaluate(model, criterion, data_loader, preprocessor, eval_step, device,
             use_lengths=False, report=None):
    """Meters (loss, CER, WER) over ``data_loader``; ``report``, if given,
    is called with each batch's decoded predictions and targets."""
    meters = utils.Meters()
    losses = []
    for inputs, widths, targets in data_loader:
        inputs, prepared = _to_device(inputs, criterion.prepare(targets), device)
        lens = output_lengths(model, widths).to(device) if use_lengths else None
        loss, outputs = eval_step(inputs, prepared, lens)
        losses.append(loss * len(targets))
        meters.num_samples += len(targets)
        predictions = criterion.viterbi_finalize(
            criterion.viterbi_dispatch(outputs, criterion.params, lens)
        )
        if report is not None:
            report(predictions, targets)
        meters.add_decodes(predictions, targets, preprocessor)
    if losses:
        meters.loss += float(torch.stack(losses).sum())
    return meters


def test(model, criterion, data_loader, preprocessor, eval_step, device,
         use_lengths=False):
    """Loss, CER and WER over ``data_loader``."""
    meters = evaluate(model, criterion, data_loader, preprocessor, eval_step,
                      device, use_lengths)
    return meters.avg_loss, meters.cer, meters.wer


def load_experiment(config, generator=None):
    """Shared setup for train.py / test.py: dataset module, preprocessor,
    criterion and model (its parameters drawn from ``generator``)."""
    from . import datasets as ds_pkg

    dataset_name = config["data"]["dataset"]
    if not hasattr(ds_pkg, dataset_name) or dataset_name == "text":
        raise ValueError(
            f"Unknown dataset {dataset_name} (the port has 'synthetic'; "
            "the others wait for their data)"
        )
    dataset = getattr(ds_pkg, dataset_name)

    input_size = config["data"]["num_features"]
    preprocessor = dataset.Preprocessor(
        config["data"].get("data_path"),
        num_features=input_size,
        tokens_path=config["data"].get("tokens", None),
        lexicon_path=config["data"].get("lexicon", None),
        prepend_wordsep=config["data"].get("prepend_wordsep", False),
    )
    criterion, output_size = utils.load_criterion(
        config.get("criterion_type", "ctc"),
        preprocessor,
        config.get("criterion", {}),
    )
    model = utils.load_model(
        config["model_type"], input_size, output_size, config["model"],
        generator=generator,
    )
    return dataset, preprocessor, criterion, model, input_size


def train(args):
    """Train as ``args`` says; returns (model, history), where history
    holds one dict of train/validation metrics per epoch."""
    device = select_device(getattr(args, "disable_cuda", False))
    with open(args.config, "r") as fid:
        config = json.load(fid)
        logging.info("Using the config \n{}".format(json.dumps(config)))

    seed = config.get("seed", 0)
    init_gen = torch.Generator().manual_seed(seed)
    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1)

    logging.info("Loading dataset ...")
    dataset, preprocessor, criterion, model, input_size = load_experiment(
        config, init_gen
    )
    data_path = config["data"].get("data_path")
    trainset = dataset.Dataset(data_path, preprocessor, split="train", augment=True)
    valset = dataset.Dataset(data_path, preprocessor, split="validation")
    train_loader = utils.data_loader(trainset, config, seed=seed)
    val_loader = utils.data_loader(valset, config, seed=seed)

    model.to(device)
    num_updates = 0
    if args.restore:
        state = utils.load_checkpoint(args.checkpoint_path, load_last=True)
        model.load_state_dict(state["model"])
        num_updates = state.get("num_updates", 0)
        logging.info(f"Restored model from epoch {args.last_epoch}")

    n_params = sum(p.numel() for p in model.parameters())
    logging.info(
        "Training {} model with {:,} parameters on {}.".format(
            config["model_type"], n_params, device
        )
    )

    epochs = config["optim"]["epochs"]
    lr = config["optim"]["learning_rate"]
    crit_lr = config["optim"].get("crit_learning_rate", lr)
    step_size = config["optim"]["step_size"]
    max_grad_norm = config["optim"].get("max_grad_norm", None)
    use_lengths = config["optim"].get("use_input_lengths", False)

    train_step = make_train_step(model, criterion, lr, crit_lr, max_grad_norm)
    eval_step = make_eval_step(model, criterion)

    timers = utils.Timer(["ds_fetch", "step", "metrics", "train_total", "test_total"])
    min_val_loss = min_val_cer = min_val_wer = float("inf")
    history = []
    for epoch in range(args.last_epoch, epochs):
        logging.info("Epoch {} started. ".format(epoch + 1))
        lr_scale = 0.5 ** (epoch // step_size)
        start_time = time.time()
        meters = utils.Meters()
        losses = []
        timers.reset()
        timers.start("train_total").start("ds_fetch")
        for inputs, widths, targets in train_loader:
            inputs, prepared = _to_device(
                inputs, criterion.prepare(targets), device
            )
            lens = output_lengths(model, widths).to(device) if use_lengths else None
            timers.stop("ds_fetch").start("step")
            loss, outputs = train_step(
                inputs, prepared, dropout_gen, lr_scale, lens
            )
            timers.stop("step").start("metrics")
            num_updates += 1
            losses.append(loss * len(targets))
            meters.num_samples += len(targets)
            predictions = criterion.viterbi_finalize(
                criterion.viterbi_dispatch(outputs, criterion.params, lens)
            )
            meters.add_decodes(predictions, targets, preprocessor)
            timers.stop("metrics").start("ds_fetch")
        if losses:
            meters.loss += float(torch.stack(losses).sum())
        timers.stop("ds_fetch").stop("train_total", sync=True)
        epoch_time = time.time() - start_time
        logging.info(
            "Epoch {} complete. "
            "nUpdates {}, Loss {:.3f}, CER {:.3f}, WER {:.3f},"
            " Time {:.3f} (s), LR {:.3f}".format(
                epoch + 1, num_updates, meters.avg_loss, meters.cer,
                meters.wer, epoch_time, lr * lr_scale,
            ),
        )
        logging.info("Evaluating validation set..")
        timers.start("test_total")
        val_loss, val_cer, val_wer = test(
            model, criterion, val_loader, preprocessor, eval_step, device,
            use_lengths,
        )
        timers.stop("test_total", sync=True)
        utils.save_checkpoint(
            args.checkpoint_path,
            {
                "model": model.state_dict(),
                "criterion": dict(criterion.params),
                "epoch": epoch,
                "num_updates": num_updates,
            },
            save_best=(val_cer < min_val_cer),
        )
        min_val_loss = min(val_loss, min_val_loss)
        min_val_cer = min(val_cer, min_val_cer)
        min_val_wer = min(val_wer, min_val_wer)
        logging.info(
            "Validation Set: Loss {:.3f}, CER {:.3f}, WER {:.3f}, "
            "Best Loss {:.3f}, Best CER {:.3f}, Best WER {:.3f}".format(
                val_loss, val_cer, val_wer, min_val_loss, min_val_cer,
                min_val_wer,
            ),
        )
        logging.info(
            "Timing Info: "
            + ", ".join(
                "{} : {:.2f}ms".format(k, v * 1000.0)
                for k, v in timers.value().items()
            )
        )
        history.append({
            "epoch": epoch + 1, "train_loss": meters.avg_loss,
            "train_cer": meters.cer, "val_loss": val_loss,
            "val_cer": val_cer, "val_wer": val_wer,
        })
    return model, history


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
