"""Fingerprint the marginalized Transducer example's set-up and train it.

    python -m gtn_applications_tpu_torch.scripts.example_fingerprint \\
        [--cpu] [--epochs N] [--save_init FILE] [--init FILE] [--out FILE]

Prints one JSON object: the Python, torch and numpy versions and the
preferred encoding; the preprocessor's graphemes and tokens; SHA-256
digests of the seeded initial weights (each tensor and all of them), of
the criterion's parameters and of the first epoch's batches (inputs,
targets and the criterion's prepared graphs); then the train history of
``examples/marginalized_transducer.py``'s config.  ``--save_init`` writes
the seeded initial weights to a file, ``--init`` trains from a file's
weights instead, so two installations can be compared on the same start.
"""

import argparse
import hashlib
import json
import locale
import os
import sys
import tempfile

import numpy as np
import torch


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x.detach().cpu().numpy()
    elif isinstance(x, np.ndarray) or np.isscalar(x):
        yield np.asarray(x)
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif hasattr(x, "__dict__"):
        yield from _leaves(vars(x))


def first_step(model, criterion, batch, state, device):
    """The loss of ``batch`` at the initial weights (``state`` if given) on
    ``device``, and its gradient's norm by parameter."""
    from .. import train as train_mod

    if state is not None:
        model.load_state_dict(state)
    model.to(device)
    train_mod.criterion_to_device(criterion, device)
    inputs, prepared = train_mod._to_device(batch[0], criterion.prepare(batch[2]), device)
    outputs = model(inputs, train=True)
    loss = criterion.loss(criterion.params, outputs, prepared, None)
    loss.backward()
    grads = {k: float(p.grad.double().norm()) for k, p in model.named_parameters()}
    return {"loss": float(loss.detach()), "outputs": _digest([outputs.detach().cpu().numpy()]),
            "outputs_abs_sum": float(outputs.detach().double().abs().sum()),
            "grad_norm": sum(v * v for v in grads.values()) ** 0.5, "grad_by_key": grads}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=25)
    parser.add_argument("--save_init", default=None)
    parser.add_argument("--init", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from .. import train as train_mod
    from .. import utils
    from ..examples import marginalized_transducer

    workdir = tempfile.mkdtemp(prefix="marg_fp_")
    config = marginalized_transducer.make_config(workdir, args.epochs)
    seed = config["seed"]
    dataset, preprocessor, criterion, model, _ = train_mod.load_experiment(
        config, torch.Generator().manual_seed(seed))
    state = model.state_dict()
    if args.save_init:
        torch.save(state, args.save_init)
    trainset = dataset.Dataset(None, preprocessor, split="train", augment=True)
    batches = list(utils.data_loader(trainset, config, 0, 1, seed))
    out = {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "numpy": np.__version__, "encoding": locale.getpreferredencoding(False),
        "graphemes": preprocessor.graphemes, "tokens": preprocessor.tokens,
        "init": _digest(state[k].numpy() for k in sorted(state)),
        "init_by_key": {k: _digest([state[k].numpy()]) for k in sorted(state)},
        "criterion_params": _digest(_leaves(dict(criterion.params))),
        "batches": _digest(_leaves([b[:2] for b in batches])),
        "targets": _digest(_leaves([b[2] for b in batches])),
        "prepared": _digest(_leaves(criterion.prepare(batches[0][2]))),
    }
    loaded = torch.load(args.init) if args.init else None
    device = train_mod.select_device(args.cpu)
    out["first_step"] = first_step(model, criterion, batches[0], loaded, device)
    print(json.dumps({k: v for k, v in out.items() if k != "init_by_key"}), flush=True)

    if loaded is not None:
        load_experiment = train_mod.load_experiment

        def seeded_then_loaded(cfg, generator=None):
            parts = load_experiment(cfg, generator)
            parts[3].load_state_dict(loaded)
            return parts

        train_mod.load_experiment = seeded_then_loaded
        out["init_loaded"] = _digest(loaded[k].numpy() for k in sorted(loaded))
    cfg = os.path.join(workdir, "config.json")
    with open(cfg, "w") as fid:
        json.dump(config, fid)
    _, history = train_mod.train(train_mod.parse_args(
        ["--config", cfg, "--checkpoint_path", workdir]
        + (["--disable_cuda"] if args.cpu else [])))
    out["history"] = history
    print(json.dumps({"init_loaded": out.get("init_loaded"),
                      "first": history[0], "last": history[-1]}), flush=True)
    if args.out:
        with open(args.out, "w") as fid:
            json.dump(out, fid, indent=1)
    return out


if __name__ == "__main__":
    main()
