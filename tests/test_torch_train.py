"""The port's train step and entry points against the JAX package.

One SGD step of JAX ``make_train_step`` and of the port's, from the same
Flax-initialised weights (loaded with ``tds2d_from_flax``) on the same
synthetic batch, with dropout 0: the loss matches to atol 1e-4, and each
parameter's update (new minus old) matches JAX's to 1e-3 of its norm (fp32
forward, CTC and backward computed by two libraries in another order; the
measured worst is 1.2e-4).  Leaves whose gradient is zero in exact
arithmetic (the bias of a dense layer just before an instance norm) are
held to 1e-3 of 1e-3 of the whole update's norm instead.  Each learning
rate makes the whole update about 0.1-0.7 in norm, far above the fp32
rounding of the parameters.  The same holds for one step with the ASG
criterion (its transitions updated at ``crit_learning_rate``) and with STC.
Then the port's ``train`` + ``run_test`` run end to end on the CPU with
``--disable_cuda``, for CTC, ASG and STC: the drivers move the criterion's
parameters to the device, switch its mode, and restore its checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu.criterions import ASG as JaxASG
from gtn_applications_tpu.criterions import CTC as JaxCTC
from gtn_applications_tpu.criterions import STC as JaxSTC
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.criterions import ASG, CTC, STC
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import (
    criterion_params_from_jax, tds2d_from_flax,
)

MODEL = {
    "depth": 2,
    "tds_groups": [
        {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
        {"channels": 8, "num_blocks": 1, "stride": [2, 1]},
    ],
    "kernel_size": [3, 5],
    "dropout": 0.0,
}


def _batch(n=8):
    pre = synthetic.Preprocessor(None, num_features=16)
    ds = synthetic.Dataset(None, pre, split="train")
    inputs, _, targets = utils.padding_collate([ds[i] for i in range(n)])
    return pre, inputs, targets


# the batch's gradient norm is about 33: the first case leaves it whole,
# the second scales it by 0.0015
@pytest.mark.parametrize("max_grad_norm,lr", [(100.0, 0.02), (0.05, 2.0)])
def test_train_step_matches_jax(max_grad_norm, lr):
    pre, inputs, targets = _batch()
    n_out = pre.num_tokens + 1
    flax_model = FlaxTDS2d(input_size=16, output_size=n_out, **MODEL)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    model = TDS2d(input_size=16, output_size=n_out, **MODEL)
    tds2d_from_flax(jax.tree_util.tree_map(np.asarray, variables), model)
    old = [p.detach().double().clone() for p in model.parameters()]

    jcrit = JaxCTC(pre.num_tokens)
    jstep = jax_train.make_train_step(flax_model, jcrit, lr, lr, max_grad_norm)
    jparams, jloss, _ = jstep(
        {"model": variables, "criterion": {}}, jnp.asarray(inputs),
        jcrit.prepare(targets), jax.random.PRNGKey(1), jnp.float32(1.0),
    )

    crit = CTC(pre.num_tokens)
    step = train_mod.make_train_step(model, crit, lr, lr, max_grad_norm)
    loss, _ = step(torch.from_numpy(inputs), crit.prepare(targets),
                   torch.Generator(), 1.0)

    assert abs(float(loss) - float(jloss)) < 1e-4
    ref = tds2d_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams["model"]),
        TDS2d(input_size=16, output_size=n_out, **MODEL),
    )
    d_port = [p.detach().double() - o for p, o in zip(model.parameters(), old)]
    d_jax = [q.detach().double() - o for q, o in zip(ref.parameters(), old)]
    total = float(torch.sqrt(sum((d ** 2).sum() for d in d_jax)))
    assert total > 0.05
    for (name, _), dp, dj in zip(model.named_parameters(), d_port, d_jax):
        scale = max(float(dj.norm()), 1e-3 * total)
        assert float((dp - dj).norm()) <= 1e-3 * scale, name


def _updates_match(before, after_port, after_jax, names):
    """Each update (new minus old) within 1e-3 of its norm (floored at
    1e-3 of the whole update's norm); returns that whole norm."""
    d_port = [p - o for p, o in zip(after_port, before)]
    d_jax = [q - o for q, o in zip(after_jax, before)]
    total = float(torch.sqrt(sum((d ** 2).sum() for d in d_jax)))
    for name, dp, dj in zip(names, d_port, d_jax):
        scale = max(float(dj.norm()), 1e-3 * total)
        assert float((dp - dj).norm()) <= 1e-3 * scale, name
    return total


# STC's "mean" divides each loss by T, so its gradient is ~30x smaller
@pytest.mark.parametrize("crit_type,lr", [("asg", 0.02), ("stc", 1.0)])
def test_train_step_matches_jax_criterion(crit_type, lr):
    """One SGD step with the ASG criterion (random start transitions, a
    criterion learning rate of its own) or STC, against JAX."""
    pre, inputs, targets = _batch()
    crit_lr, max_grad_norm = 0.5, 100.0
    if crit_type == "asg":
        crit, jcrit = ASG(pre.num_tokens, 1, True), JaxASG(pre.num_tokens, 1, True)
        n_out = crit.N
        trans = (np.random.RandomState(0).randn(n_out + 1, n_out) * 0.1).astype(
            np.float32)
        jcrit_params = {"transitions": jnp.asarray(trans)}
    else:
        kw = dict(p0=1.0, plast=0.1, thalf=4.0, reduction="mean", shift_targets=1)
        crit, jcrit = STC(**kw), JaxSTC(**kw)
        n_out = pre.num_tokens + 1
        jcrit_params = {}
    crit.params = criterion_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jcrit_params))

    flax_model = FlaxTDS2d(input_size=16, output_size=n_out, **MODEL)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    model = TDS2d(input_size=16, output_size=n_out, **MODEL)
    tds2d_from_flax(jax.tree_util.tree_map(np.asarray, variables), model)
    params = list(model.parameters()) + list(crit.params.values())
    old = [p.detach().double().clone() for p in params]

    jstep = jax_train.make_train_step(flax_model, jcrit, lr, crit_lr, max_grad_norm)
    jparams, jloss, _ = jstep(
        {"model": variables, "criterion": jcrit_params}, jnp.asarray(inputs),
        jcrit.prepare(targets), jax.random.PRNGKey(1), jnp.float32(1.0),
    )
    step = train_mod.make_train_step(model, crit, lr, crit_lr, max_grad_norm)
    loss, _ = step(torch.from_numpy(inputs), crit.prepare(targets),
                   torch.Generator(), 1.0)
    assert abs(float(loss) - float(jloss)) < 1e-4

    ref = tds2d_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams["model"]),
        TDS2d(input_size=16, output_size=n_out, **MODEL),
    )
    ref_params = list(ref.parameters()) + list(criterion_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams["criterion"])).values())
    names = [n for n, _ in model.named_parameters()] + list(crit.params)
    total = _updates_match(old, [p.detach().double() for p in params],
                           [q.detach().double() for q in ref_params], names)
    assert total > 0.05
    if crit_type == "asg":
        moved = params[-1].detach().double() - old[-1]
        assert float(moved.norm()) > 1e-3


def test_clip_global_norm_formula():
    rng = np.random.RandomState(0)
    gs = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        ref = jax_train.clip_global_norm([jnp.asarray(g) for g in gs], max_norm)
        out = train_mod.clip_global_norm([torch.from_numpy(g.copy()) for g in gs],
                                         max_norm)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_train_and_eval_cpu(tmp_path):
    config = {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 16},
        "model_type": "tds2d",
        "model": MODEL,
        "criterion_type": "ctc",
        "optim": {"batch_size": 16, "epochs": 1, "learning_rate": 0.02,
                  "step_size": 40, "max_grad_norm": 5},
    }
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    args = train_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(tmp_path),
         "--disable_cuda"]
    )
    model, history = train_mod.train(args)
    assert os.path.exists(tmp_path / "model.checkpoint")
    assert os.path.exists(tmp_path / "model.checkpoint.best")
    assert np.isfinite(history[-1]["train_loss"])
    assert np.isfinite(history[-1]["val_loss"])

    targs = test_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(tmp_path),
         "--split", "test", "--disable_cuda"]
    )
    meters = test_mod.run_test(targs)
    assert meters.num_samples == 16
    assert np.isfinite(meters.avg_loss)

    # --restore continues from the last checkpoint for the remaining epochs
    config["optim"]["epochs"] = 2
    cfg.write_text(json.dumps(config))
    _, more = train_mod.train(train_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(tmp_path),
         "--disable_cuda", "--restore", "--last_epoch", "1"]
    ))
    assert [h["epoch"] for h in more] == [2]
    assert np.isfinite(more[0]["train_loss"])


def _config(criterion_type, criterion=None, **optim):
    config = {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 16},
        "model_type": "tds2d",
        "model": MODEL,
        "criterion_type": criterion_type,
        "optim": dict({"batch_size": 16, "epochs": 1, "learning_rate": 0.02,
                       "step_size": 40, "max_grad_norm": 5}, **optim),
    }
    if criterion is not None:
        config["criterion"] = criterion
    return config


def _write(tmp_path, config):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    return str(cfg)


def test_asg_test_decodes_with_restored_transitions(tmp_path, capsys):
    """train.py saves the learned transitions; test.py and --restore load
    them back: transitions that force one token on every frame make every
    decoded line that token."""
    cfg = _write(tmp_path, _config("asg", {"num_replabels": 1},
                                   crit_learning_rate=0.05))
    ckpt = ["--checkpoint_path", str(tmp_path), "--disable_cuda"]
    train_mod.train(train_mod.parse_args(["--config", cfg] + ckpt))
    state = utils.load_checkpoint(str(tmp_path), load_last=True)
    trained = state["criterion"]["transitions"]
    assert float(trained.abs().sum()) > 0  # the criterion's parameters trained

    pre = synthetic.Preprocessor(None, num_features=16)
    k = pre.num_tokens - 1           # token k is model output k + num_replabels
    forced = torch.full_like(trained, -1e3)
    forced[0, k + 1] = 1e3
    forced[k + 2, k + 1] = 1e3
    state["criterion"]["transitions"] = forced
    utils.save_checkpoint(str(tmp_path), state, save_best=True)  # last and best

    capsys.readouterr()
    meters = test_mod.run_test(test_mod.parse_args(
        ["--config", cfg, "--split", "test"] + ckpt))
    hyps = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("HYP: ")]
    assert meters.num_samples == 16 and len(hyps) == 16
    assert set(hyps) == {f"HYP: {pre.tokens_to_text([k])}"}

    # --restore with zero learning rates carries the checkpoint's
    # transitions through another epoch unchanged
    cfg = _write(tmp_path, _config("asg", {"num_replabels": 1}, epochs=2,
                                   learning_rate=0.0, crit_learning_rate=0.0))
    train_mod.train(train_mod.parse_args(
        ["--config", cfg, "--restore", "--last_epoch", "1"] + ckpt))
    state = utils.load_checkpoint(str(tmp_path), load_last=True)
    assert torch.equal(state["criterion"]["transitions"], forced)


def test_drivers_switch_criterion_mode(tmp_path, monkeypatch):
    """STC anneals once per train step: train.py switches the criterion to
    eval for validation, and test.py evaluates in eval mode."""
    made = []

    def capture(module):
        real = module.load_experiment

        def load_experiment(*args, **kwargs):
            out = real(*args, **kwargs)
            made.append(out[2])
            return out
        monkeypatch.setattr(module, "load_experiment", load_experiment)

    capture(train_mod)
    capture(test_mod)
    cfg = _write(tmp_path, _config(
        "stc", {"p0": 1.0, "plast": 0.1, "thalf": 4000, "reduction": "mean"}))
    ckpt = ["--checkpoint_path", str(tmp_path), "--disable_cuda"]
    _, history = train_mod.train(train_mod.parse_args(["--config", cfg] + ckpt))
    assert np.isfinite(history[-1]["train_loss"])
    assert np.isfinite(history[-1]["val_loss"])
    crit = made[-1]
    assert crit.nstep == 64 // 16 and not crit.training

    meters = test_mod.run_test(test_mod.parse_args(
        ["--config", cfg, "--split", "test"] + ckpt))
    assert np.isfinite(meters.avg_loss) and meters.num_samples == 16
    assert made[-1].nstep == 0 and not made[-1].training


def test_to_device_moves_nested_prepared():
    prepared = {
        "select": torch.arange(3),
        "log_penalty": -0.5,
        "dense": {"adj0": np.zeros((2, 2), np.float32),
                  "pair": (torch.ones(2), np.ones(1))},
    }
    out = train_mod.to_device(prepared, torch.device("meta"))
    assert out["log_penalty"] == -0.5
    assert out["select"].device.type == "meta"
    assert out["dense"]["adj0"].device.type == "meta"
    assert [t.device.type for t in out["dense"]["pair"]] == ["meta", "meta"]
    inputs, tup = train_mod._to_device(np.zeros((1, 2), np.float32),
                                       (torch.zeros(1), torch.ones(1)),
                                       torch.device("meta"))
    assert inputs.device.type == "meta" and isinstance(tup, tuple)


def test_criterion_params_follow_the_device():
    crit = ASG(4, 1, True)
    train_mod.criterion_to_device(crit, torch.device("meta"))
    (trans,) = crit.params.values()
    assert trans.device.type == "meta" and trans.requires_grad and trans.is_leaf
    assert tuple(trans.shape) == (crit.N + 1, crit.N)


@pytest.mark.parametrize("crit_type,n_extra", [("asg", 2), ("stc", 1), ("ctc", 1)])
def test_load_criterion_output_sizes(crit_type, n_extra):
    pre = synthetic.Preprocessor(None, num_features=16)
    config = {"num_replabels": 1} if crit_type == "asg" else {}
    crit, n_out = utils.load_criterion(crit_type, pre, config)
    assert n_out == pre.num_tokens + n_extra
    if crit_type == "stc":
        assert crit.reduction == "mean" and crit.shift_targets == 1
    # the Transducer resolves (one extra channel with a blank); a
    # transitions file that does not exist is an error
    crit, n_out = utils.load_criterion("transducer", pre, {"blank": "optional"})
    assert n_out == pre.num_tokens + 1 and crit.reduction == "mean"
    with pytest.raises(FileNotFoundError):
        utils.load_criterion("transducer", pre, {"transitions": "missing-lm.bin"})
