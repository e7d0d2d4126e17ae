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
rounding of the parameters.  Then the port's ``train`` + ``run_test`` run
end to end on the CPU with ``--disable_cuda``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu.criterions import CTC as JaxCTC
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import tds2d_from_flax

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
