"""The port's RNN and TDS encoders, and the bf16 compute of TDS and TDS2d,
against the JAX package's Flax modules on the same weights.

The Flax ``init`` draws the parameters; ``rnn_from_flax`` /
``tds_from_flax`` / ``tds2d_from_flax`` load them (and, through the same
maps, JAX's parameter gradients) into the port.  Inputs are numpy-seeded
[B, H, W] images whose last sample is zero-padded over its last columns:
both packages run the recurrence over the padding, as JAX does.

Tolerances: fp32 outputs within 1e-5 (RNN) and 2e-5 (TDS; instance norms
and dense layers summed in another order), input and parameter
gradients within 1e-4; bf16 models against JAX's bf16 model within 2e-2
(a few bf16 ulps of the logits' size), their logits fp32 and their
parameters fp32, within 0.15 of the fp32 model (JAX's
``tests/test_models.py`` bound at this narrow width) and their CTC loss
within 1e-2 of the fp32 model's, relative.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu.criterions import CTC as JaxCTC
from gtn_applications_tpu.models import RNN as FlaxRNN
from gtn_applications_tpu.models import TDS as FlaxTDS
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.models import RNN, TDS, TDS2d, TDS2dTransducer
from gtn_applications_tpu_torch.models.convert import (
    rnn_from_flax, tds2d_from_flax, tds_from_flax,
)

RNN_CFG = dict(input_size=12, output_size=6, hidden_size=7, num_layers=2,
               channels=(2, 3), kernel_sizes=((3, 3), (5, 3)), strides=((1, 2), (2, 2)))
TDS_CFG = dict(input_size=12, output_size=6, kernel_size=5, dropout=0.0,
               tds_groups=[{"channels": 2, "num_blocks": 1},
                           {"channels": 3, "num_blocks": 2, "stride": 1}])
TDS2D_CFG = dict(input_size=16, output_size=6, depth=2, kernel_size=(3, 5), dropout=0.0,
                 tds_groups=[{"channels": 2, "num_blocks": 1, "stride": [2, 2]},
                             {"channels": 4, "num_blocks": 1, "stride": [2, 1]}])


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _image(H, W, seed, B=3):
    x = np.random.RandomState(seed).randn(B, H, W).astype(np.float32)
    x[-1, :, W - 7:] = 0.0  # the batch's padded columns
    return x


def _grads_match(model, ref, jgrads, atol):
    """Each parameter's gradient against JAX's ``jgrads``, loaded into the
    module ``ref`` by the converter."""
    for (name, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.detach().numpy(), rtol=1e-4,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_rnn_matches_flax(cell, bidirectional):
    x = _image(12, 23, seed=len(cell) + bidirectional)
    kw = dict(RNN_CFG, cell_type=cell, bidirectional=bidirectional)
    flax_model = FlaxRNN(**kw)
    variables = flax_model.init(jax.random.PRNGKey(1), x)
    ref, vjp = jax.vjp(jax.jit(lambda v: flax_model.apply(variables, v)), jnp.asarray(x))
    cot = np.random.RandomState(5).randn(*ref.shape).astype(np.float32)
    (j_gx,) = vjp(jnp.asarray(cot))

    model = rnn_from_flax(_as_numpy(variables), RNN(**kw), cell)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = model(x_t)
    (g_x,) = torch.autograd.grad(out, x_t, torch.from_numpy(cot))
    assert out.shape == ref.shape == (3, 6, 6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(j_gx), rtol=0, atol=1e-4)


def test_tds_and_its_ctc_gradient_match_jax():
    """TDS logits, then CTC on them: the loss, and its gradients to the
    input image and to every parameter."""
    x = _image(12, 40, seed=3)
    flax_model = FlaxTDS(**TDS_CFG)
    variables = flax_model.init(jax.random.PRNGKey(2), x)
    targets = [[1, 2, 3], [4, 4], [0, 2, 1, 3]]
    jcrit, crit = JaxCTC(5, impl="scan"), CTC(5)
    jprep = jcrit.prepare(targets)

    def jax_loss(v, x):
        return jcrit.loss({}, flax_model.apply(v, x), jprep)

    ref = np.asarray(flax_model.apply(variables, x))
    j_loss, (j_gv, j_gx) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        variables, jnp.asarray(x))

    model = tds_from_flax(_as_numpy(variables), TDS(**TDS_CFG))
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = model(x_t)
    assert out.shape == ref.shape == (3, 20, 6) and model.time_stride == 2
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=2e-5)
    loss = crit.loss({}, out, crit.prepare(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-4)
    _grads_match(model, tds_from_flax(_as_numpy(j_gv), TDS(**TDS_CFG)), j_gv, atol=1e-4)


@pytest.mark.parametrize("name", ["tds", "tds2d"])
def test_bf16_compute_matches_jax(name):
    flax_cls, cls, load, cfg, H = {
        "tds": (FlaxTDS, TDS, tds_from_flax, TDS_CFG, 12),
        "tds2d": (FlaxTDS2d, TDS2d, tds2d_from_flax, TDS2D_CFG, 16),
    }[name]
    x = _image(H, 32, seed=7)
    flax16 = flax_cls(**cfg, dtype=jnp.bfloat16)
    variables = flax16.init(jax.random.PRNGKey(0), x)
    # op by op, as each op's output is rounded to bf16 in the port too (a
    # jitted fusion keeps some intermediates in fp32)
    ref16 = np.asarray(flax16.apply(variables, x))
    params = _as_numpy(variables)

    model = load(params, cls(**cfg, dtype=torch.bfloat16))
    model32 = load(params, cls(**cfg))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = model(x_t)
    assert out.dtype == torch.float32  # logits stay fp32
    np.testing.assert_allclose(out.detach().numpy(), ref16, rtol=0, atol=2e-2)
    with torch.no_grad():
        out32 = model32(torch.from_numpy(x))
    assert float((out.detach() - out32).abs().max()) < 0.15
    # the CTC loss's relative gap, the bound chip_smoke.py holds its bf16 path to
    crit = CTC(cfg["output_size"] - 1)
    prepared = crit.prepare([[1, 2, 3], [4, 4], [0, 2, 1]])
    l16, l32 = (float(crit.loss({}, o.detach(), prepared)) for o in (out, out32))
    assert abs(l16 - l32) / abs(l32) < 1e-2
    # the backward reaches the fp32 parameters and the input
    out.square().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert torch.isfinite(x_t.grad).all()


def test_load_model_builds_the_encoders(tmp_path):
    gen = torch.Generator().manual_seed(0)
    for name, cls, stride in (("rnn", RNN, 4), ("tds", TDS, 4), ("tds2d", TDS2d, 4)):
        with open(f"configs/iamdb/{name}.json") as fid:
            cfg = json.load(fid)["model"]
        model = utils.load_model(name, 64, 80, dict(cfg, dtype="bfloat16"), generator=gen)
        assert isinstance(model, cls) and model.time_stride == stride
        assert model.linear.out_features == 80
        # bf16 compute for the TDS encoders; the RNN ignores the key, as JAX does
        assert getattr(model, "dtype", None) == (None if name == "rnn" else torch.bfloat16)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        if name != "rnn":
            fp32 = utils.load_model(name, 64, 80, dict(cfg, dtype="float32"))
            assert fp32.dtype == torch.float32
    # the transducer model from convtrans.json's model section, its inner
    # inventory a small token file (the dtype key dropped, as JAX drops it)
    with open("configs/iamdb/convtrans.json") as fid:
        cfg = json.load(fid)["model"]
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("ab\nba\na\nb\nabc\n")
    model = utils.load_model("tds2d_transducer", 64, 80,
                             dict(cfg, tokens=str(tokens), dtype="bfloat16"), generator=gen)
    assert isinstance(model, TDS2dTransducer) and model.time_stride == 16
    assert model.conv.kernel_size == 7 and model.conv.scale == math.sqrt(7)
    assert model.tds1.linear.out_features == 4  # a, b, c and the blank
    assert model.linear.in_features == 5 and model.tds2.linear.out_features == 80
    assert model.tds1.dtype == model.tds2.dtype == torch.float32
    with open("configs/iamdb/rnn.json") as fid:
        cfg = json.load(fid)["model"]
    with pytest.raises(ValueError, match="cell type"):
        utils.load_model("rnn", 64, 80, dict(cfg, cell_type="tree"))


def test_rnn_json_lacks_step_size_in_both_trainers(tmp_path):
    """``configs/iamdb/rnn.json`` has no ``optim.step_size``, which both
    trainers read: each raises the same KeyError (its model narrowed, its
    data the synthetic lines)."""
    with open("configs/iamdb/rnn.json") as fid:
        config = json.load(fid)
    assert "step_size" not in config["optim"]
    config["data"] = {"dataset": "synthetic", "data_path": None, "num_features": 16}
    config["model"].update(hidden_size=4, channels=[2, 2])
    config["optim"]["epochs"] = 1
    cfg = tmp_path / "rnn.json"
    cfg.write_text(json.dumps(config))
    argv = ["--config", str(cfg), "--checkpoint_path", str(tmp_path)]
    with pytest.raises(KeyError) as port:
        train_mod.train(train_mod.parse_args(argv + ["--disable_cuda"]))
    with pytest.raises(KeyError) as ref:
        jax_train.train(jax_train.parse_args(argv))
    assert port.value.args == ref.value.args == ("step_size",)
