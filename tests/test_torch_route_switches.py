"""JAX's route switches in the port, against the JAX package.

``GTN_STC_DENSE``, ``GTN_SPARSE_SCAN`` and ``GTN_VITERBI_SCAN`` are read
at import into ``criterions.stc._DENSE_IMPL``, ``ops.sparse._SCAN_IMPL``
and ``ops.sparse._VIT_IMPL`` under JAX's names, values and aliases (on and
off for whole and step); the tests set the module attributes of both
packages by ``monkeypatch``, as JAX's own tests do.

- ``GTN_STC_DENSE=off`` (or ``0``): STC prepares and scores every batch on
  its sparse arc-table tier; loss and input gradient against JAX's on the
  same route at ``tests/test_torch_stc.py``'s tolerances.
- ``GTN_SPARSE_SCAN=step``: the kernel route (``_forward_batched_kernels``)
  scans frame by frame, one ``seg_lse`` a frame and the epsilon closure,
  against JAX's per-step route (``_forward_batched_pallas``, its Pallas
  ``seg_lse`` in interpret mode, under ``jax.jit``) at the tolerances of
  ``tests/test_torch_sparse_scan.py``'s interpret-mode comparison; with
  the CUDA route forced and plain stand-ins for the kernels, each frame is
  one seg_lse launch a round forward and backward, the gather pair once,
  and no whole scan.
- ``GTN_VITERBI_SCAN=step``: ``viterbi_batch`` decodes through T
  ``seg_max`` steps and the walk, labels equal to JAX's per-step route
  (``_viterbi_batched_pallas`` in interpret mode, and JAX's
  ``viterbi_batch`` under "step", its per-sample oracle on the CPU)
  exactly on data without near ties; forced onto the CUDA route, one
  ``seg_max`` launch a frame and no whole-scan kernel.
- "whole" and "auto" keep the port's routes.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import stc as jax_stc
from gtn_applications_tpu.ops import sparse as jax_sparse
from gtn_applications_tpu_torch.criterions import STC
from gtn_applications_tpu_torch.criterions import stc as stc_mod
from gtn_applications_tpu_torch.ops import _build, factored, gathers, sparse
from gtn_applications_tpu_torch.ops import seglse_pallas as slp
from gtn_applications_tpu_torch.ops import segmax_pallas as smp
from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
from gtn_applications_tpu_torch.ops.semiring import NEG
from tests.test_torch_seglse import _endpoints, _stand_ins
from tests.test_torch_sparse_scan import (
    SCORE_TOL, _feasible_sum, _jax_table, _port_scores, _tables,
)
from tests.test_torch_viterbi_scan import _step_tables

ROOT = Path(__file__).resolve().parents[1]
B, T, S, A, E, C = 4, 7, 6, 20, 5, 5
# JAX's seg_lse shifts each row by its largest contribution, the port's
# each destination by its own: tests/test_torch_sparse_scan.py's bounds
# against JAX's Pallas kernels in interpret mode
STEP_SCORE_TOL = dict(rtol=1e-5, atol=1e-4)
STEP_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def test_switches_are_read_from_the_environment():
    """The three switches at import, with JAX's aliases, in a fresh
    process; unset, "auto"."""
    code = ("from gtn_applications_tpu_torch.criterions import stc\n"
            "from gtn_applications_tpu_torch.ops import sparse\n"
            "print(stc._DENSE_IMPL, sparse._SCAN_IMPL, sparse._VIT_IMPL)\n")
    env = dict(os.environ, GTN_STC_DENSE="0", GTN_SPARSE_SCAN="off",
               GTN_VITERBI_SCAN="on")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["0", "step", "whole"]
    for name in ("GTN_SPARSE_SCAN", "GTN_VITERBI_SCAN"):
        assert getattr(sparse, "_SCAN_IMPL" if "SPARSE" in name else "_VIT_IMPL") == \
            sparse._norm_impl(os.environ.get(name, "auto"))


# -- GTN_STC_DENSE ----------------------------------------------------------


@pytest.mark.parametrize("value,seed,layout", [("off", 0, "union"), ("0", 1, "union"),
                                               ("off", 2, "stacked")])
def test_stc_dense_off_scores_on_the_sparse_tier_as_jax(monkeypatch, value, seed, layout):
    """Under the switch the dense tier is never built (the working-set
    gate would admit these batches) and the loss goes through the sparse
    tier, as JAX's does under the same value."""
    from gtn_applications_tpu.wfst import compile as jax_wcompile
    from gtn_applications_tpu_torch.wfst import compile as wcompile

    monkeypatch.setattr(stc_mod, "_DENSE_IMPL", value)
    monkeypatch.setattr(jax_stc, "_DENSE_IMPL", value)
    if layout == "stacked":
        monkeypatch.setattr(wcompile, "union_stack_arc_tables", lambda cgs: None)
        monkeypatch.setattr(jax_wcompile, "union_stack_arc_tables", lambda cgs: None)
    called = []
    monkeypatch.setattr(factored, "alignment_lattice_score",
                        lambda *a, **k: pytest.fail("the dense tier ran"))
    score = sparse.forward_score_batch_tables
    monkeypatch.setattr(sparse, "forward_score_batch_tables",
                        lambda *a, **k: called.append(1) or score(*a, **k))
    b, t, c = 3, 10, 7
    rng = np.random.default_rng(seed)
    kw = dict(p0=0.4, plast=0.1, thalf=4.0, reduction="mean", shift_targets=1)
    crit, jcrit = STC(**kw), jax_stc.STC(**kw)
    inputs = rng.normal(size=(b, t, c)).astype(np.float32)
    targets = [rng.integers(0, c - 1, size=rng.integers(1, 4)).tolist() for _ in range(b)]
    lens = rng.integers(3, t + 1, size=b).astype(np.int32)
    prep, jprep = crit.prepare(targets), jcrit.prepare(targets)
    assert "dense" not in prep and "dense" not in jprep
    monkeypatch.setattr(stc_mod, "_DENSE_IMPL", "auto")
    assert "dense" in STC(**kw).prepare(targets)  # the gate admits the batch
    x = torch.from_numpy(inputs).requires_grad_(True)
    loss = crit.loss({}, x, prep, torch.from_numpy(lens))
    (gx,) = torch.autograd.grad(loss, x)
    assert called == [1]
    j_loss, j_gx = jax.jit(jax.value_and_grad(
        lambda x: jcrit.loss({}, x, jprep, jnp.asarray(lens))))(jnp.asarray(inputs))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-5)


# -- GTN_SPARSE_SCAN --------------------------------------------------------


def _jax_step_scores(em, t, depth, lens):
    """JAX's per-step route (``_SCAN_IMPL = "step"``) under jax.jit."""
    table = _jax_table(t, depth)

    @jax.jit
    def f(em, w, ew):
        tb = dataclasses.replace(table, weight=w, eps_weight=ew)
        return jax_sparse._forward_batched_pallas(em, tb, jnp.asarray(lens))

    args = (jnp.asarray(em), jnp.asarray(t["weight"]), jnp.asarray(t["eps_weight"]))
    grads = jax.jit(jax.grad(lambda *a: _feasible_sum(f(*a)), argnums=(0, 1, 2)))(*args)
    return np.asarray(f(*args)), [np.asarray(g) for g in grads]


def _refuse(what):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{what} ran on the step route")
    return refuse


@pytest.mark.parametrize("impl", ["step", "off"])
@pytest.mark.parametrize("layout,depth", [("shared", 2), ("per_sample", 0), ("union", 3)])
def test_sparse_scan_step_matches_jax(monkeypatch, impl, layout, depth):
    monkeypatch.setattr(sparse, "_SCAN_IMPL", impl)
    monkeypatch.setattr(jax_sparse, "_SCAN_IMPL", impl)
    t = _tables(layout, B, S, A, E if depth else 0, C, seed=30 + depth)
    rng = np.random.RandomState(31 + depth)
    em = rng.randn(B, T, C).astype(np.float32)
    lens = np.asarray([T, T - 2, 0, 1], np.int32)
    steps = []
    seg_lse = slp.seg_lse
    monkeypatch.setattr(slp, "seg_lse", lambda *a: steps.append(1) or seg_lse(*a))
    monkeypatch.setattr(ssp, "scan_scores", _refuse("the whole scan"))
    scores, grads = _port_scores(sparse._forward_batched_kernels, em, t, depth, lens)
    assert len(steps) == depth + T * (1 + depth)
    j_scores, j_grads = _jax_step_scores(em, t, depth, lens)
    np.testing.assert_allclose(scores, j_scores, **STEP_SCORE_TOL)
    for name, a, b in zip(("dem", "dw", "deps"), grads, j_grads):
        np.testing.assert_allclose(a, b, err_msg=name, **STEP_GRAD_TOL)


def _gather_stand_ins(monkeypatch, calls):
    monkeypatch.setattr(gathers, "gather_fwd_cuda", lambda x, idx: calls.append(
        "gather_fwd") or gathers.gather_channels_plain(x, idx))
    monkeypatch.setattr(gathers, "gather_bwd_cuda", lambda g, idx, c: calls.append(
        "gather_bwd") or gathers.gather_channels_bwd_plain(g, idx, c))


@pytest.mark.parametrize("layout,depth", [("union", 2), ("per_sample", 0)])
def test_sparse_scan_step_cuda_route_launches_a_step_a_frame(monkeypatch, layout, depth):
    """The step route forced onto the CUDA route (plain stand-ins for the
    kernels that read the arc index): the gather pair once, one seg_lse
    forward and backward for each frame's arcs and each closure round, no
    whole scan; the CPU route's scores and gradients."""
    t = _tables(layout, B, S, A, E if depth else 0, C, seed=40 + depth)
    em = np.random.RandomState(41).randn(B, T, C).astype(np.float32)
    lens = np.asarray([T, 3, 0, 1], np.int32)
    ref = _port_scores(sparse.forward_score_batch_tables, em, t, depth, lens)
    calls = []
    monkeypatch.setattr(sparse, "_SCAN_IMPL", "step")
    _stand_ins(monkeypatch, calls)
    _gather_stand_ins(monkeypatch, calls)
    monkeypatch.setattr(ssp, "scan_scores", _refuse("the whole scan"))
    got = _port_scores(sparse.forward_score_batch_tables, em, t, depth, lens)
    n = depth + T * (1 + depth)
    assert sorted(calls) == sorted(["gather_fwd", "gather_bwd"] + ["fwd", "bwd"] * n)
    np.testing.assert_allclose(got[0], ref[0], **SCORE_TOL)
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("impl", ["whole", "on", "auto"])
def test_sparse_scan_whole_and_auto_keep_the_whole_scan(monkeypatch, impl):
    monkeypatch.setattr(sparse, "_SCAN_IMPL", impl)
    t = _tables("shared", B, S, A, E, C, seed=50)
    em = np.random.RandomState(51).randn(B, T, C).astype(np.float32)
    calls = []
    scan = ssp.scan_scores
    monkeypatch.setattr(ssp, "scan_scores", lambda *a: calls.append(1) or scan(*a))
    _port_scores(sparse._forward_batched_kernels, em, t, 2, np.full(B, T, np.int32))
    assert calls == [1]


# -- GTN_VITERBI_SCAN -------------------------------------------------------


def _decode_case(name, T_):
    table, jtable, c = _step_tables(name)
    rng = np.random.default_rng(60 + T_)
    em = rng.normal(size=(3, T_, c)).astype(np.float32)
    lens = np.asarray([T_, max(T_ - 4, 0), T_], np.int32)
    em[2, T_ // 2] = NEG  # an all-NEG frame: sample 2 has no accepting path
    return table, jtable, em, lens


@pytest.mark.parametrize("impl", ["step", "off"])
@pytest.mark.parametrize("name,T_", [("seglse test graph", 9), ("4-gram", 12),
                                     ("4-gram", 1)])
def test_viterbi_step_matches_jax(monkeypatch, impl, name, T_):
    """The seglse test graph's table is one the whole-scan plan takes, the
    4-gram's one it refuses: under "step" both decode by seg_max steps."""
    monkeypatch.setattr(sparse, "_VIT_IMPL", impl)
    monkeypatch.setattr(jax_sparse, "_VIT_IMPL", impl)
    table, jtable, em, lens = _decode_case(name, T_)
    monkeypatch.setattr(vsp, "viterbi_scan", _refuse("the whole-scan Viterbi"))
    monkeypatch.setattr(smp, "seg_max_scan", _refuse("seg_max_scan"))
    labels, score = sparse.viterbi_batch(torch.from_numpy(em), table, torch.from_numpy(lens))
    jp_labels, jp_score = jax.jit(jax_sparse._viterbi_batched_pallas)(
        jnp.asarray(em), jtable, jnp.asarray(lens))
    j_labels, j_score = jax_sparse.viterbi_batch(jnp.asarray(em), jtable, jnp.asarray(lens))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jp_labels))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(score.numpy(), np.asarray(jp_score), rtol=0, atol=1e-6)
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=0, atol=1e-5)
    assert labels[2].tolist() == [-1] * T_ and float(score[2]) <= NEG / 2


def _seg_max_stand_in(calls):
    """``seg_max_cuda`` on CPU tensors: the plain step on the index's
    sorted arcs, their winning positions mapped back to arc ids."""
    def stand_in(alpha, w_s, row, idx):
        calls.append("seg_max")
        src, dst = _endpoints(idx)
        lab = torch.full_like(src, -1).scatter_(1, idx.arc.long(), idx.label.long())
        w = torch.zeros_like(w_s).scatter_(1, idx.order.expand_as(w_s), w_s)
        return smp.seg_max_plain(alpha, src, dst, w, row, lab)
    return stand_in


@pytest.mark.parametrize("name", ["seglse test graph", "4-gram"])
def test_viterbi_step_cuda_route_launches_a_step_a_frame(monkeypatch, name):
    table, _, em, lens = _decode_case(name, 9)
    ref = sparse._viterbi_steps(torch.from_numpy(em), table, torch.from_numpy(lens))
    calls = []
    monkeypatch.setattr(sparse, "_VIT_IMPL", "step")
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(smp, "seg_max_cuda", _seg_max_stand_in(calls))
    monkeypatch.setattr(smp, "seg_max_scan_cuda", _refuse("seg_max_scan"))
    monkeypatch.setattr(vsp, "viterbi_scan_fwd_cuda", _refuse("the whole-scan Viterbi"))
    plans = {}
    for _ in range(2):  # the labelled arc index is built once
        labels, score = sparse.viterbi_batch(torch.from_numpy(em), table,
                                             torch.from_numpy(lens), plans)
        np.testing.assert_array_equal(labels.numpy(), ref[0].numpy())
        np.testing.assert_array_equal(score.numpy(), ref[1].numpy())
    assert calls == ["seg_max"] * 18 and len(plans) == 1


@pytest.mark.parametrize("impl", ["whole", "on", "auto"])
@pytest.mark.parametrize("name,route", [("seglse test graph", "viterbi_scan"),
                                        ("4-gram", "seg_max_scan")])
def test_viterbi_whole_and_auto_keep_their_routes(monkeypatch, impl, name, route):
    monkeypatch.setattr(sparse, "_VIT_IMPL", impl)
    table, _, em, lens = _decode_case(name, 9)
    calls = []
    mod = vsp if route == "viterbi_scan" else smp
    fn = getattr(mod, route)
    monkeypatch.setattr(mod, route, lambda *a: calls.append(route) or fn(*a))
    monkeypatch.setattr(smp, "seg_max", _refuse("seg_max"))
    sparse.viterbi_batch(torch.from_numpy(em), table, torch.from_numpy(lens))
    assert calls == [route]
