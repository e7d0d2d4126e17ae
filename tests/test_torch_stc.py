"""The port's STC criterion (dense and sparse tiers) against the JAX package.

Same targets, same numpy-seeded logits, same annealing step: the port's
``STC.loss`` (its ``dense_scan`` plain versions on CPU tensors) against JAX
``STC.loss`` on its default dense tier, at the tolerances of
``tests/test_stc_dense.py``: loss rtol 1e-5 + atol 1e-5, input gradient
rtol 1e-4 + atol 1e-5.  The host tables (adjacency, labels, start, accept)
must be equal; the greedy decode must give the same token ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import stc as jax_stc
from gtn_applications_tpu.wfst import compile as jax_wcompile
from gtn_applications_tpu_torch.criterions import STC
from gtn_applications_tpu_torch.criterions import stc as stc_mod
from gtn_applications_tpu_torch.wfst import compile as wcompile


def _pair(**kw):
    return STC(**kw), jax_stc.STC(**kw)


@pytest.mark.parametrize("seed,B,T,C,reduction,nstep", [
    (0, 3, 9, 7, "none", 0), (1, 4, 12, 10, "mean", 3), (2, 2, 6, 5, "none", 9),
])
def test_stc_loss_matches_jax(seed, B, T, C, reduction, nstep):
    rng = np.random.default_rng(seed)
    kw = dict(p0=0.4, plast=0.1, thalf=4.0, reduction=reduction, shift_targets=1)
    crit, jcrit = _pair(**kw)
    crit.nstep = jcrit.nstep = nstep  # a point along the annealing schedule
    inputs = rng.normal(size=(B, T, C)).astype(np.float32)
    targets = [rng.integers(0, C - 1, size=rng.integers(1, 4)).tolist()
               for _ in range(B)]
    lens = rng.integers(2, T + 1, size=B).astype(np.int32)

    prep = crit.prepare(targets)
    jprep = jcrit.prepare(targets)
    assert crit.nstep == jcrit.nstep == nstep + 1
    assert prep["log_penalty"] == pytest.approx(float(jprep["log_penalty"]), abs=1e-7)
    np.testing.assert_array_equal(prep["select"].numpy(), np.asarray(jprep["select"]))
    for key in ("adj0", "adj_star", "lab_oh", "start", "accept"):
        np.testing.assert_array_equal(prep["dense"][key].numpy(),
                                      np.asarray(jprep["dense"][key]), err_msg=key)

    x = torch.from_numpy(inputs).requires_grad_(True)
    loss = crit.loss({}, x, prep, torch.from_numpy(lens))
    (gx,) = torch.autograd.grad(loss, x)
    j_loss, j_gx = jax.value_and_grad(
        lambda x: jcrit.loss({}, x, jprep, jnp.asarray(lens)))(jnp.asarray(inputs))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-5)


def test_stc_penalty_schedule_matches_jax():
    """Four training steps along the schedule: the loss moves with the
    penalty identically in both packages."""
    rng = np.random.default_rng(5)
    inputs = rng.normal(size=(2, 8, 6)).astype(np.float32)
    targets = [[1, 2], [3]]
    crit, jcrit = _pair(p0=1.0, plast=0.05, thalf=2.0, shift_targets=1)
    port, ref = [], []
    for _ in range(4):
        port.append(float(crit.loss({}, torch.from_numpy(inputs), crit.prepare(targets))))
        ref.append(float(jcrit.loss({}, jnp.asarray(inputs), jcrit.prepare(targets))))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    assert len(set(port)) == 4


def test_stc_anneals_only_in_training_mode():
    crit = STC(p0=1.0, plast=0.1, thalf=2.0, shift_targets=1)
    crit.prepare([[1, 2]])
    crit.eval()
    crit.prepare([[1, 2]])
    assert crit.nstep == 1
    crit.train()
    crit.prepare([[1, 2]])
    assert crit.nstep == 2


def test_stc_refused_by_dense_gate_raises(monkeypatch):
    """A batch that the dense tier's gate refuses no longer raises: it
    takes the sparse tier (an arc table with its star-arc mask)."""
    monkeypatch.setattr(stc_mod, "_DENSE_MAX_WORKSET", 10)
    prep = STC(shift_targets=1).prepare([[1, 2]])
    assert "dense" not in prep
    assert prep["table"].src.dim() == 1 and prep["star_mask"].shape[0] == 1


@pytest.mark.parametrize("seed,B,T,C,layout", [
    (0, 3, 9, 7, "union"), (1, 4, 12, 10, "union"), (2, 2, 6, 5, "stacked"),
])
def test_stc_sparse_tier_matches_jax(monkeypatch, seed, B, T, C, layout):
    """The dense gate shut (the port's working-set limit patched to 0):
    STC's sparse tier, union or stacked tables with the penalty on the
    star arcs, against JAX's with ``stc._DENSE_IMPL = "off"``; tables,
    star masks and penalty exactly, loss rtol 1e-5 + atol 1e-5, input
    gradient rtol 1e-4 + atol 1e-5."""
    monkeypatch.setattr(stc_mod, "_DENSE_MAX_WORKSET", 0)
    monkeypatch.setattr(jax_stc, "_DENSE_IMPL", "off")
    if layout == "stacked":  # no union skeleton: graphs stacked per sample
        monkeypatch.setattr(wcompile, "union_stack_arc_tables", lambda cgs: None)
        monkeypatch.setattr(jax_wcompile, "union_stack_arc_tables",
                            lambda cgs: None)
    rng = np.random.default_rng(seed)
    crit, jcrit = _pair(p0=0.4, plast=0.1, thalf=4.0, reduction="mean", shift_targets=1)
    inputs = rng.normal(size=(B, T, C)).astype(np.float32)
    targets = [rng.integers(0, C - 1, size=rng.integers(1, 4)).tolist()
               for _ in range(B)]
    lens = rng.integers(2, T + 1, size=B).astype(np.int32)
    prep, jprep = crit.prepare(targets), jcrit.prepare(targets)
    assert "dense" not in prep
    assert (prep["table"].src.dim() == 1) == (layout == "union")
    for f in ("src", "dst", "label", "weight", "start", "accept", "eps_src",
              "eps_dst", "eps_weight"):
        np.testing.assert_array_equal(getattr(prep["table"], f).numpy(),
                                      np.asarray(getattr(jprep["table"], f)), err_msg=f)
    np.testing.assert_array_equal(prep["star_mask"].numpy(), np.asarray(jprep["star_mask"]))

    x = torch.from_numpy(inputs).requires_grad_(True)
    loss = crit.loss({}, x, prep, torch.from_numpy(lens))
    (gx,) = torch.autograd.grad(loss, x)
    j_loss, j_gx = jax.value_and_grad(
        lambda x: jcrit.loss({}, x, jprep, jnp.asarray(lens)))(jnp.asarray(inputs))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-5)


def test_logsubexp_matches_jax():
    rng = np.random.default_rng(3)
    b = rng.normal(size=(2, 5, 4)).astype(np.float32)
    a = np.log(np.exp(b).sum(-1, keepdims=True) + 0.5).astype(np.float32)
    np.testing.assert_allclose(
        stc_mod.logsubexp(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_stc.logsubexp(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def test_stc_viterbi_matches_jax():
    rng = np.random.default_rng(4)
    out = rng.normal(size=(3, 10, 6)).astype(np.float32)
    lens = np.array([10, 4, 7], np.int32)
    crit, jcrit = _pair(shift_targets=1)
    preds = crit.viterbi(torch.from_numpy(out), None, torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(out), None, jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [p.tolist() for p in j_preds]


def test_compile_acceptor_matches_jax():
    g = stc_mod.make_stc_graph([1, 2, 2], star_idx=8)
    jg = jax_stc.make_stc_graph([1, 2, 2], star_idx=8)
    cg, jcg = wcompile.compile_acceptor(g), jax_wcompile.compile_acceptor(jg)
    assert cg._fields == jcg._fields
    for name, a, b in zip(cg._fields, cg, jcg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    for semiring in ("log", "tropical"):
        cg = wcompile.compile_acceptor(g, semiring=semiring, remove_eps=True)
        jcg = jax_wcompile.compile_acceptor(jg, semiring=semiring, remove_eps=True)
        assert cg.eps_depth == 0 and len(cg.eps_src) == 0
        for name, a, b in zip(cg._fields, cg, jcg):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
