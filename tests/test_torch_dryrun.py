"""The port's multi-process dry run against JAX's train step on a 2-device mesh.

One spawn of two gloo ranks (``parallel.mesh.spawn``, workers in
``tests/torch_dist_workers.py``, which import no JAX) runs one train step
of each leg of ``gtn_applications_tpu_torch.dryrun`` (ctc on the
flagship's TDS2d, asg, stc, transducer_ngram, transducer_plain,
tds2d_transducer and the loaded backoff LM) from JAX's initial weights,
carried across by the converters, each rank on its half of the global
batch.  JAX runs ``make_train_step`` on the same global batch sharded over
two of ``tests/conftest.py``'s virtual devices.  The loss is held within
1e-5 relative, every parameter after the step within rtol 1e-4 / atol
1e-5 (``tests/test_fused_steps_mesh.py``'s tolerances).

The same spawn runs a CTC step whose ranks collate to different widths
(the narrow half of a batch on rank 0, the wide half on rank 1), which
``train.shard_batch`` pads to the widest rank's: against JAX's step on the
whole batch collated once, at the same tolerances; ``Meters.sync`` of
rank-dependent counts; and that each rank's step outputs hold its own
rows, which it decodes (JAX's ``local_rows``).
"""

import threading

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import utils as jax_utils
from gtn_applications_tpu.criterions import ASG as JaxASG
from gtn_applications_tpu.criterions import CTC as JaxCTC
from gtn_applications_tpu.criterions import STC as JaxSTC
from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu.models import TDS2dTransducer as FlaxTDS2dTransducer
from gtn_applications_tpu.parallel import mesh as jax_mesh
from gtn_applications_tpu.scripts import build_transitions as jax_bt
from gtn_applications_tpu.train import make_train_step as jax_make_train_step
from gtn_applications_tpu_torch import dryrun
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import (
    tds2d_from_flax, tds2d_transducer_from_flax,
)
from gtn_applications_tpu_torch.parallel import mesh as pmesh

from tests import torch_dist_workers as workers

N = 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores, and a CPU train loop with a thread per core each slows ~70x
    under that contention (as in ``tests/test_torch_ctc_long.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TinyEncoder(nn.Module):
    """The encoder of JAX's dryrun (``__graft_entry__.dryrun_multichip``)."""
    output_size: int

    @nn.compact
    def __call__(self, inputs, train=False):
        h = nn.relu(nn.Dense(32)(inputs))
        return nn.Dense(self.output_size)(h)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_criterion(name):
    C = dryrun.C
    tokens, g2i = [(i,) for i in range(C)], {i: i for i in range(C)}
    if name == "asg":
        return JaxASG(C, num_replabels=1, use_garbage=True)
    if name == "stc":
        return JaxSTC(blank_idx=0, reduction="mean", shift_targets=1)
    if name == "transducer_ngram":
        return jax_td.Transducer(tokens, g2i, ngram=2, blank="optional", reduction="mean")
    if name == "transducer_plain":
        return jax_td.Transducer(tokens + [(0, 1), (1, 2)], g2i, blank="optional",
                                 allow_repeats=False, reduction="mean")
    _, lines = dryrun.backoff_transitions(C)
    t2i = {str(i): i for i in range(C)}
    kept = jax_bt.prune_ngrams(jax_bt.count_ngrams(lines, 2, t2i), [0, 1])
    graph = jax_bt.build_graph(jax_bt.add_blank_grams(kept, C, "optional"))
    return jax_td.Transducer([str(i) for i in range(C)], t2i, transitions=graph,
                             blank="optional", reduction="mean")


def _jax_leg(name, tmp_path):
    """(Flax model, JAX criterion) of a leg."""
    if name == "ctc":
        # the flagship as JAX's dryrun builds it (__graft_entry__._flagship)
        model = FlaxTDS2d(
            input_size=64, output_size=80, depth=4,
            tds_groups=[
                {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
                {"channels": 16, "num_blocks": 1, "stride": [2, 2]},
                {"channels": 32, "num_blocks": 1, "stride": [2, 1]},
                {"channels": 64, "num_blocks": 1, "stride": [2, 1]},
            ],
            kernel_size=[5, 7], dropout=0.0,
        )
        return model, JaxCTC(blank=79)
    if name == "tds2d_transducer":
        tokens = tmp_path / "tokens.txt"
        tokens.write_text(dryrun.TDS2D_TRANSDUCER_TOKENS)
        tds2 = {**dryrun.TINY_TDS,
                "tds_groups": [{"channels": 2, "num_blocks": 1, "stride": [1, 1]}]}
        model = FlaxTDS2dTransducer(input_size=8, output_size=6, tokens=str(tokens),
                                    kernel_size=5, stride=2, tds1=dict(dryrun.TINY_TDS),
                                    tds2=tds2, wfst=True)
        return model, JaxCTC(blank=5)
    crit = _jax_criterion(name)
    _, out_size = dryrun.criterion_suite(name)
    return TinyEncoder(output_size=out_size), crit


def _port_state(name, params, tmp_path):
    """JAX's model parameters as the port's leg's state (numpy)."""
    model, _ = dryrun.build_leg(name, str(tmp_path))
    p = params["params"] if "params" in params else params
    if name == "ctc":
        tds2d_from_flax(params, model)
    elif name == "tds2d_transducer":
        tds2d_transducer_from_flax(params, model)
    else:
        return {"dense0.weight": np.asarray(p["Dense_0"]["kernel"]).T,
                "dense0.bias": np.asarray(p["Dense_0"]["bias"]),
                "dense1.weight": np.asarray(p["Dense_1"]["kernel"]).T,
                "dense1.bias": np.asarray(p["Dense_1"]["bias"])}
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _jax_step(model, crit, params, x, targets, lr):
    """JAX's train step on a 2-device data mesh: (loss, new params)."""
    mesh = jax_mesh.make_mesh(jax.devices()[:N])
    # JAX gates the transitions-free factored prep on the TPU; its dryrun
    # forces it, as the port's auto route takes it
    plain = isinstance(crit, jax_td.Transducer) and crit.transitions is None
    saved, jax_td._FACTORED_IMPL = jax_td._FACTORED_IMPL, "on" if plain else jax_td._FACTORED_IMPL
    try:
        prepared = crit.prepare(targets)
    finally:
        jax_td._FACTORED_IMPL = saved
    with mesh:
        p = jax_mesh.replicate(params, mesh)
        xs = jax_mesh.global_batch_from_local(x, mesh)
        prep = jax_mesh.global_pytree_from_local(prepared, mesh, x.shape[0])
        step = jax_make_train_step(model, crit, lr, lr, 5.0)
        new, loss, _ = step(p, xs, prep, jax.random.PRNGKey(1), 1.0)
        return float(loss), _numpy(new)


def _hold_state(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}: {k}", **PARAM_TOL)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks' results from JAX's initial weights of every leg and
    of the padding case, and JAX's steps from them (computed while the
    ranks run): {leg: (loss, the port's state of JAX's new parameters)}."""
    tmp = tmp_path_factory.mktemp("dryrun")
    legs = {}
    for name in dryrun.LEGS:
        model, crit = _jax_leg(name, tmp)
        x, targets, _ = dryrun.leg_data(name, N)
        # jitted: Flax's eager init of the TDS2d encoders takes 4x as long
        params = {"model": _numpy(jax.jit(model.init)(jax.random.PRNGKey(2),
                                                      jnp.asarray(x[:1]))),
                  "criterion": _numpy(crit.init_params())}
        state = _port_state(name, params["model"], tmp)
        state.update({f"criterion.{k}": v for k, v in params["criterion"].items()})
        legs[name] = (model, crit, params, state)

    pre, halves = workers.pad_case_samples()
    inputs, _, targets = jax_utils.padding_collate(halves[0] + halves[1])
    flax_model = FlaxTDS2d(input_size=16, output_size=pre.num_tokens + 1, **workers.PAD_MODEL)
    pad_params = _numpy(jax.jit(flax_model.init)(jax.random.PRNGKey(0), jnp.asarray(inputs)))
    port_model = TDS2d(input_size=16, output_size=pre.num_tokens + 1, **workers.PAD_MODEL)
    tds2d_from_flax(pad_params, port_model)
    pad_state = {k: v.detach().numpy() for k, v in port_model.state_dict().items()}

    ranks = {}

    def run_ranks():
        try:
            ranks["results"] = pmesh.spawn(
                workers.dryrun_against_jax, N,
                args=({k: v[3] for k, v in legs.items()}, pad_state), timeout=600)
        except Exception as exc:  # raised below, in the test's thread
            ranks["error"] = exc

    thread = threading.Thread(target=run_ranks)
    thread.start()
    want = {}
    try:
        for name, (model, crit, params, _) in legs.items():
            x, targets_leg, _ = dryrun.leg_data(name, N)
            loss, new = _jax_step(model, crit, params, x, targets_leg, dryrun.LR)
            state = _port_state(name, new["model"], tmp)
            state.update({f"criterion.{k}": v for k, v in new["criterion"].items()})
            want[name] = (loss, state)
        loss, new = _jax_step(flax_model, JaxCTC(pre.num_tokens),
                              {"model": pad_params, "criterion": {}}, inputs, targets,
                              workers.PAD_LR)
        model = TDS2d(input_size=16, output_size=pre.num_tokens + 1, **workers.PAD_MODEL)
        tds2d_from_flax(new["model"], model)
        want["pad"] = (loss, {k: v.detach().numpy() for k, v in model.state_dict().items()})
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return ranks["results"], want, (inputs, targets)


@pytest.mark.parametrize("name", dryrun.LEGS)
def test_dryrun_leg_matches_jax(spawned, name):
    results, want, _ = spawned
    loss, state = want[name]
    for rank, r in enumerate(results):
        got = r[name]
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (rank, got["loss"], loss)
        _hold_state(got["params"], state, f"{name} rank {rank}")


def test_ranks_padded_to_different_widths_match_jax(spawned):
    results, want, (inputs, targets) = spawned
    pad = [r["pad"] for r in results]
    assert pad[0]["local_width"] < pad[1]["local_width"]
    assert pad[0]["width"] == pad[1]["width"] == inputs.shape[2]
    assert [p["rows"] for p in pad] == [len(targets) // N] * N
    loss, state = want["pad"]
    for rank, p in enumerate(pad):
        assert abs(p["loss"] - loss) <= LOSS_RTOL * abs(loss), (rank, p["loss"], loss)
        _hold_state(p["params"], state, f"padding case rank {rank}")


def test_meters_sync_sums_over_ranks(spawned):
    results, _, _ = spawned
    want = [1.5 + 2.5, 3 + 4, 10 + 20, 0 + 1, 2 + 2, 1 + 1]
    for r in results:
        assert r["sync"] == want


def test_dryrun_ranks_launch_no_kernel_on_the_cpu(spawned):
    results, _, _ = spawned
    for r in results:
        assert set(r["launches"].values()) == {0}


def test_dryrun_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """Without a GPU the entry point and ``dryrun_multichip`` raise before
    spawning, unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--n", "2"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.dryrun_multichip(2)
