"""The sequence-parallel train step (``optim.seq_parallel``) on gloo CPU
ranks against one process and JAX's unsharded step.

A small TDS2d (depth 2, channels 4 and 8, time strides 1 and 2, kernels
[3, 5] and [5, 7], so halos of 2 and 3 frames) from Flax's initial weights
(``models/convert.py``) on random [4, 16, 40] inputs with CTC targets.  One
spawn of two ranks on a ``('data', 'seq')`` grid of 1 x 2 (the workers in
``tests/torch_dist_workers.py`` import no JAX), each holding 20 of the 40
frames through the encoder, and one spawn of four ranks on 2 x 2, each
holding 2 rows and 20 frames:

  * one step at lr 1 without clipping: the loss within 1e-5 relative, the
    logits (each rank's shard, joined) and the gradient (the parameters'
    change) within rtol 1e-4 / atol 1e-5 of the one-process port's and of
    JAX's ``jax.value_and_grad`` of the unsharded loss;
  * three steps at the recipe's lr 0.02 with clipping at 5: every loss and
    the parameters after the last step at the same tolerances;
  * the CTC "assoc" route (the sharded operator composition) and the 1-D
    TDS encoder (which gathers its input along time and runs whole),
    against one process;
  * a width of 42, whose 21-frame shards the stride of 2 does not divide,
    keeps time whole on every rank (with the warning) and equals one
    process too.

The 2-epoch ``train.py`` run with ``seq_parallel`` 2 is in
``tests/test_torch_train_dist.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import CTC as JaxCTC
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.models.convert import tds2d_from_flax
from gtn_applications_tpu_torch.parallel import mesh as pmesh

from tests import torch_dist_workers as workers

B, H, W, C = 4, 16, 40, 8
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-5)
KERNELS = {"k3x5": [3, 5], "k5x7": [5, 7]}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (as in ``tests/test_torch_ctc_long.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax(kernel, inputs):
    model = FlaxTDS2d(input_size=H, output_size=C, kernel_size=kernel, **workers.SEQ_MODEL)
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(inputs))


def _weights(kind, kernel, inputs):
    if kind == "tds":
        torch.manual_seed(0)
        model = workers.seq_model(kind, kernel, C)
    else:
        model = tds2d_from_flax(jax.tree_util.tree_map(np.asarray, _flax(kernel, inputs)[1]),
                                workers.seq_model(kind, kernel, C))
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _data(width=W, seed=0):
    rng = np.random.RandomState(seed)
    inputs = rng.randn(B, H, width).astype(np.float32)
    targets = [rng.randint(0, C - 1, size=rng.randint(2, 6)).tolist() for _ in range(B)]
    return inputs, targets


# name -> (encoder, kernel, criterion options, width, lr, max_grad_norm, steps)
CASES = {
    "k3x5": ("tds2d", KERNELS["k3x5"], {}, W, 1.0, None, 1),
    "k5x7": ("tds2d", KERNELS["k5x7"], {}, W, 1.0, None, 1),
    "k5x7_three_steps": ("tds2d", KERNELS["k5x7"], {}, W, 0.02, 5.0, 3),
    "assoc": ("tds2d", KERNELS["k3x5"], {"impl": "assoc", "chunk": 4}, W, 1.0, None, 1),
    "tds_gathered": ("tds", KERNELS["k3x5"], {}, W, 1.0, None, 1),
    "width_42_whole": ("tds2d", KERNELS["k3x5"], {}, 42, 1.0, None, 1),
}
GRID_CASES = ("k5x7", "k5x7_three_steps")


def _case_args(name):
    kind, kernel, crit_kw, width, lr, max_norm, steps = CASES[name]
    inputs, targets = _data(width)
    return (kind, kernel, _weights(kind, kernel, inputs), dict(crit_kw, blank=C - 1),
            inputs, targets, lr, max_norm, steps)


def _one_process(args):
    """The same steps in one process on the whole batch."""
    kind, kernel, weights, crit_kw, inputs, targets, lr, max_norm, steps = args
    crit = CTC(**crit_kw)
    model = workers.seq_model(kind, kernel, C)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    step = train_mod.make_train_step(model, crit, lr, lr, max_norm)
    prepared = crit.prepare(targets)
    losses, params = [], []
    for k in range(steps):
        loss, outputs = step(torch.from_numpy(inputs), prepared, torch.Generator(), 1.0)
        losses.append(float(loss))
        if k == 0:
            first_outputs = outputs.numpy()
        if k in (0, steps - 1):
            params.append({k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    return {"losses": losses, "outputs": first_outputs, "first": params[0],
            "last": params[-1]}


@pytest.fixture(scope="module")
def runs():
    args = {name: _case_args(name) for name in CASES}
    one = {name: _one_process(a) for name, a in args.items()}
    pairs = pmesh.spawn(workers.seq_steps, 2, args=(2, [args[n] for n in CASES]), timeout=600)
    grid = pmesh.spawn(workers.seq_steps, 4, args=(2, [args[n] for n in GRID_CASES]),
                       timeout=600)
    return (args, one, {n: [r[i] for r in pairs] for i, n in enumerate(CASES)},
            {n: [r[i] for r in grid] for i, n in enumerate(GRID_CASES)})


def _joined_outputs(ranks, seq):
    """The logits [B, T', C] from each rank's rows and time shard
    (ranks in the grid's order: data major)."""
    lines = [np.concatenate([r["outputs"] for r in ranks[d * seq:(d + 1) * seq]], axis=1)
             for d in range(len(ranks) // seq)]
    return np.concatenate(lines, axis=0)


def _hold(ranks, ref, seq, sharded=True):
    for r in ranks:
        assert (r["axis"] == 2) is sharded
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=LOSS_RTOL)
        for k, v in ref["last"].items():
            np.testing.assert_allclose(r["last"][k], v, err_msg=k, **TOL)
    outputs = _joined_outputs(ranks, seq) if sharded else np.concatenate(
        [r["outputs"] for r in ranks[::seq]], axis=0)
    np.testing.assert_allclose(outputs, ref["outputs"], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_two_seq_ranks_step_like_one_process(runs, name):
    args, one, pairs, _ = runs
    _hold(pairs[name], one[name], 2, sharded=name != "width_42_whole")


@pytest.mark.parametrize("name", GRID_CASES)
def test_two_by_two_grid_steps_like_one_process(runs, name):
    _, one, _, grid = runs
    assert [list(r["rows"]) for r in grid[name]] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    _hold(grid[name], one[name], 2)


@pytest.mark.parametrize("name", ["k3x5", "k5x7"])
def test_sharded_step_matches_jax_unsharded(runs, name):
    """JAX's loss, logits and gradient of the whole batch from the same
    weights; the step at lr 1 without clipping changes each parameter by
    its gradient."""
    args, _, pairs, _ = runs
    kind, kernel, weights, crit_kw, inputs, targets, *_ = args[name]
    flax_model, variables = _flax(kernel, inputs)
    jcrit = JaxCTC(crit_kw["blank"])
    prepared = jcrit.prepare(targets)

    def loss_fn(v):
        outputs = flax_model.apply(v, jnp.asarray(inputs))
        return jcrit.loss({}, outputs, prepared), outputs

    (j_loss, j_out), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    j_grads = tds2d_from_flax(jax.tree_util.tree_map(np.asarray, j_grads),
                              workers.seq_model(kind, kernel, C)).state_dict()
    ranks = pairs[name]
    np.testing.assert_allclose(_joined_outputs(ranks, 2), np.asarray(j_out), **TOL)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], float(j_loss), rtol=LOSS_RTOL)
        for k, w in weights.items():
            np.testing.assert_allclose(w - r["first"][k], j_grads[k].numpy(), err_msg=k,
                                       **TOL)


def test_time_shard_rules():
    """Which widths the TDS2d of ``configs/iamdb/tds2d.json`` (kernel 7,
    time strides 2, 2, 1, 1) and the small model split into time shards,
    and the gathered route's rule for other encoders."""
    big = workers.TDS2d(input_size=64, output_size=C, depth=4, kernel_size=[5, 7],
                        dropout=0.0, tds_groups=[
                            {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
                            {"channels": 16, "num_blocks": 1, "stride": [2, 2]},
                            {"channels": 32, "num_blocks": 1, "stride": [2, 1]},
                            {"channels": 64, "num_blocks": 1, "stride": [2, 1]}])
    assert big.fits_time_shards(176, 2) and big.fits_time_shards(176, 4)
    assert not big.fits_time_shards(174, 2)   # 87-frame shards, stride 2
    assert not big.fits_time_shards(16, 4)    # 1-frame shards at the last group
    small = workers.seq_model("tds2d", KERNELS["k5x7"], C)
    assert small.fits_time_shards(40, 2) and not small.fits_time_shards(42, 2)
    assert not small.fits_time_shards(8, 2)   # 2-frame shards, halo 3
    tds = workers.seq_model("tds", KERNELS["k3x5"], C)
    assert train_mod.time_shards_fit(tds, 40, 2) and not train_mod.time_shards_fit(tds, 42, 2)
    mesh = pmesh.Mesh((1, 2), ("data", "seq"))
    x = torch.zeros(B, H, 42)
    assert train_mod.shard_time(x, mesh, 2, small)[1] is None
    assert train_mod.shard_time(torch.zeros(B, H, 40), mesh, 2, small)[0].shape[2] == 20
