"""The port's ``TDS2dTransducer`` against the Flax model on the same
weights, and one CPU train step of it through the port's ``train.py``.

``TDS2dTransducer.init`` of the JAX package draws the parameters (the
learned kernels' arc weights then set at random, so that they matter);
``tds2d_transducer_from_flax`` loads them into the port.  Both run the
widths of ``tests/test_tds2d_transducer.py`` on the same numpy input, in
eval mode with dropout 0, in float64 (JAX under ``jax.enable_x64`` and
``jax.jit``): in float32 two libraries' convolutions and reductions
already differ by ~1e-4 in one encoder (``test_torch_tds2d.py``).  The
logits are held within rtol 1e-5 (atol 1e-6), every parameter's gradient
and the input's within 1e-5 + 1e-4 |g|, for the WFST layer, the
``Conv1d`` control, learned kernels and the Viterbi layer under
``normalize="post"``.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.models import TDS2dTransducer as FlaxTDS2dTransducer
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.models import TDS2dTransducer
from gtn_applications_tpu_torch.models.convert import tds2d_transducer_from_flax
from gtn_applications_tpu_torch.scripts import make_wordpieces, wordpiece

TDS1 = {
    "depth": 2,
    "tds_groups": [{"channels": 2, "num_blocks": 1, "stride": [2, 2]}],
    "kernel_size": [3, 3],
    "dropout": 0.0,
}
TDS2 = {
    "depth": 2,
    "tds_groups": [{"channels": 2, "num_blocks": 1, "stride": [1, 1]}],
    "kernel_size": [3, 3],
    "dropout": 0.0,
}
CASES = {
    "wfst": dict(wfst=True),
    "control": dict(wfst=False),
    "learned": dict(wfst=True, conv_kwargs={"learn_params": True, "scale": "sqrt"}),
    "viterbi_post": dict(wfst=True, conv_kwargs={"viterbi": True, "normalize": "post"}),
}


@pytest.fixture
def tokens(tmp_path):
    path = tmp_path / "tokens.txt"
    path.write_text("ab\nba\na\nb\n")
    return str(path)


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(tokens, kw, x, rng):
    """Flax's model, its float32 parameters (random learned kernels), and
    its float64 logits and gradients for the cotangent drawn from rng."""
    model = FlaxTDS2dTransducer(input_size=8, output_size=6, tokens=tokens,
                                kernel_size=5, stride=2, tds1=TDS1, tds2=TDS2, **kw)
    params = _as_numpy(model.init(jax.random.PRNGKey(0), x))
    if "kernel_params" in params["params"]:
        n = params["params"]["kernel_params"].shape[0]
        params["params"]["kernel_params"] = (0.3 * rng.randn(n)).astype(np.float32)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        x64 = jnp.asarray(x, jnp.float64)

        @jax.jit
        def fwd_bwd(p, x, g):
            out, vjp = jax.vjp(lambda p, x: model.apply(p, x), p, x)
            return out, vjp(g)

        out = jax.jit(lambda p, x: model.apply(p, x))(p64, x64)
        g = rng.randn(*out.shape)
        out, (gp, gx) = fwd_bwd(p64, x64, jnp.asarray(g))
        return model, params, np.asarray(out), _as_numpy(gp), np.asarray(gx), g


def _hold_grad(got, want, what):
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert np.all(err <= 1e-5 + 1e-4 * np.abs(want)), (what, err.max())


@pytest.mark.parametrize("case", list(CASES))
def test_tds2d_transducer_matches_flax(tokens, case):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 16).astype(np.float32)
    flax_model, params, ref, ref_gp, ref_gx, g = _jax_model(tokens, CASES[case], x, rng)

    model = TDS2dTransducer(8, 6, tokens, 5, 2, TDS1, TDS2, **CASES[case])
    tds2d_transducer_from_flax(params, model)
    assert model.time_stride == 4
    model = model.double()
    model.tds1.dtype = model.tds2.dtype = torch.float64
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    out = model(xt)
    out.backward(torch.from_numpy(g))
    assert out.shape == ref.shape == (2, 4, 6)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    _hold_grad(xt.grad.numpy(), ref_gx, "input")
    # the JAX gradient tree through the converter: each parameter's
    # gradient lands where that parameter does
    want = tds2d_transducer_from_flax(ref_gp, copy.deepcopy(model).float())
    want = dict(want.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert names == list(want)
    assert ("conv.kernel_params" in names) == (case == "learned")
    for name, p in model.named_parameters():
        _hold_grad(p.grad.numpy(), want[name].detach().double().numpy(), name)
    if case == "learned":
        assert np.abs(model.conv.kernel_params.grad.numpy()).sum() > 0


def _wordpiece_files(tmp_path, n):
    """A wordpiece inventory of n pieces over the synthetic corpus, built
    by the port's trainer: (tokens, lexicon) paths."""
    tmp_path.mkdir()
    model = wordpiece.train_unigram(synthetic._make_corpus(400, 11), n)
    vocab = sorted({w for split in (1, 2, 3) for t in synthetic._make_corpus(64, split)
                    for w in t.split("▁")})
    prefix = str(tmp_path / "wp")
    make_wordpieces.save_pieces(model, n, prefix, vocab)
    return f"{prefix}_tokens_{n}.txt", f"{prefix}_lex_{n}.txt"


def test_train_step_through_train_py(tmp_path):
    """One CPU train step (and the validation pass) of the model with
    learned kernels, CTC over a 30-piece inventory and a 20-piece inner
    one, through ``train.py``, then ``test.py`` on its checkpoint; the
    learned kernels move."""
    outer_tokens, outer_lex = _wordpiece_files(tmp_path / "outer", 30)
    inner_tokens, _ = _wordpiece_files(tmp_path / "inner", 20)
    config = {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 8, "num_samples": 4,
                 "tokens": outer_tokens, "lexicon": outer_lex},
        "model_type": "tds2d_transducer",
        "model": {"tokens": inner_tokens, "kernel_size": 7, "stride": 2,
                  "tds1": dict(TDS1, dropout=0.1), "tds2": dict(TDS2, dropout=0.1),
                  "wfst": True, "conv_kwargs": {"learn_params": True, "scale": "sqrt"}},
        "criterion_type": "ctc",
        "optim": {"batch_size": 4, "epochs": 1, "learning_rate": 0.1,
                  "step_size": 100, "max_grad_norm": 5},
    }
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    argv = ["--config", str(cfg), "--checkpoint_path", str(tmp_path), "--disable_cuda"]
    model, history = train_mod.train(train_mod.parse_args(argv))
    assert isinstance(model, TDS2dTransducer) and model.time_stride == 4
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["val_loss"])
    assert model.conv.kernel_params.detach().abs().sum() > 0
    assert model.tds2.linear.out_features == 31  # 30 pieces and the blank
    meters = test_mod.run_test(test_mod.parse_args(argv))
    assert meters.num_samples == 4 and np.isfinite(meters.avg_loss)
