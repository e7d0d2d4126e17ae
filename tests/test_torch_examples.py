"""The port's two examples run on the CPU with their epochs cut to one:
``examples/quickstart.py`` trains and tests (16 test lines), and
``examples/marginalized_transducer.py`` trains the transitions-free
Transducer over the example's wordpieces; their losses are finite.  The
pieces file and config are the JAX example's (its ``config`` dict and
``pieces`` list).  The marginalized example's first epoch also goes
through JAX's ``train.train`` and the port's from the same initial
weights, step for step."""

import ast
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.examples import marginalized_transducer, quickstart
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import tds2d_from_flax
from tests.test_torch_train import _updates_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores, and a CPU train loop with a thread per core each slows ~70x
    under that contention (as in ``tests/test_torch_ctc_long.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example_value(name, target):
    """A literal assigned at the top of the JAX example ``name``."""
    with open(os.path.join(ROOT, "examples", name)) as fid:
        tree = ast.parse(fid.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == target:
            return node.value
    raise KeyError(target)


def test_quickstart_runs_on_cpu(tmp_path):
    config = ast.literal_eval(_jax_example_value("quickstart.py", "CONFIG"))
    config["data"].pop("data_path")
    assert config == quickstart.CONFIG
    history, meters = quickstart.main(["--cpu", "--epochs", "1", "--workdir", str(tmp_path)])
    assert len(history) == 1 and math.isfinite(history[0]["val_loss"])
    assert meters.num_samples == 16 and math.isfinite(meters.avg_loss)


def test_marginalized_transducer_runs_on_cpu(tmp_path):
    pieces = _jax_example_value("marginalized_transducer.py", "pieces")
    assert eval(compile(ast.Expression(pieces), "pieces", "eval")) == \
        marginalized_transducer.PIECES
    history = marginalized_transducer.main(
        ["--cpu", "--epochs", "1", "--workdir", str(tmp_path)])
    assert len(history) == 1
    assert math.isfinite(history[0]["train_loss"]) and math.isfinite(history[0]["val_loss"])


def test_marginalized_transducer_first_epoch_matches_jax(tmp_path, monkeypatch):
    """The example's config, one epoch, through JAX's ``train.train`` and
    the port's, the port starting from JAX's initial weights (converted):
    every step's loss and the validation loss within 1e-4 relative, and
    each parameter's update over the epoch within 1e-3 of its norm
    (floored at 1e-3 of the whole update's; ``test_torch_train.py``'s
    tolerance), in float32.  Both step through the same batches: the
    port's ``train`` draws the batch order that JAX's spends on its
    initialisation's sample batch."""
    config = marginalized_transducer.make_config(str(tmp_path), epochs=1)
    jax_cfg, port_cfg = tmp_path / "jax.json", tmp_path / "port.json"
    jax_cfg.write_text(json.dumps(
        dict(config, data=dict(config["data"], data_path=str(tmp_path)))))
    port_cfg.write_text(json.dumps(config))
    seen = {"jax": [], "port": [], "init": None}

    jax_make_step = jax_train.make_train_step

    def jax_recording_step(*args, **kwargs):
        step = jax_make_step(*args, **kwargs)

        def recorded(params, *rest):
            if seen["init"] is None:
                seen["init"] = jax.tree_util.tree_map(np.asarray, params["model"])
            out = step(params, *rest)
            seen["jax"].append(float(out[1]))
            return out
        return recorded

    jax_test = jax_train.test

    def jax_recording_test(*args, **kwargs):
        seen["jax_val"] = jax_test(*args, **kwargs)
        return seen["jax_val"]

    monkeypatch.setattr(jax_train, "make_train_step", jax_recording_step)
    monkeypatch.setattr(jax_train, "test", jax_recording_test)
    jparams = jax_train.train(jax_train.parse_args(
        ["--config", str(jax_cfg), "--checkpoint_path", str(tmp_path / "jax")]))

    port_make_step = train_mod.make_train_step

    def port_recording_step(*args, **kwargs):
        step = port_make_step(*args, **kwargs)

        def recorded(*rest):
            out = step(*rest)
            seen["port"].append(float(out[0]))
            return out
        return recorded

    load_experiment = train_mod.load_experiment

    def from_jax_init(cfg, generator=None):
        parts = load_experiment(cfg, generator)
        tds2d_from_flax(seen["init"], parts[3])
        return parts

    monkeypatch.setattr(train_mod, "make_train_step", port_recording_step)
    monkeypatch.setattr(train_mod, "load_experiment", from_jax_init)
    (tmp_path / "port").mkdir()
    model, history = train_mod.train(train_mod.parse_args(
        ["--config", str(port_cfg), "--checkpoint_path", str(tmp_path / "port"),
         "--disable_cuda"]))

    assert len(seen["jax"]) == len(seen["port"]) == 8
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-4)
    np.testing.assert_allclose(history[0]["val_loss"], seen["jax_val"][0], rtol=1e-4)

    def port_model(flax_params):
        return tds2d_from_flax(flax_params, TDS2d(
            input_size=16, output_size=model.linear.out_features, **config["model"]))

    before = [p.detach().double() for p in port_model(seen["init"]).parameters()]
    after_jax = [p.detach().double() for p in port_model(
        jax.tree_util.tree_map(np.asarray, jparams["model"])).parameters()]
    names = [n for n, _ in model.named_parameters()]
    total = _updates_match(before, [p.detach().double() for p in model.parameters()],
                           after_jax, names)
    assert total > 0.1
