"""The port's sparse forward scores against the JAX package.

``ops.sparse.forward_score_batch(_tables)`` takes, on CPU tensors, the
plain route (``forward_score`` over the batch, differentiated by
autograd); ``_forward_batched_kernels`` is the route CUDA tensors take
(``seg_lse`` for the start closure, then the whole scan ``sparse_scan``
with its hand-written VJP), here with the kernels' plain versions.  Both
are held to JAX's ``sparse.forward_score_batch_tables`` (its vmapped plain
route on the CPU) within rtol 1e-5 + atol 1e-5 on scores and rtol 1e-5 +
atol 2e-6 on the gradients to the emissions, the arc weights and the
epsilon weights: epsilon depths 0, 2 and 3; shared, per-sample and union
layouts; ragged, zero-length and infeasible samples; T = 1.  At tiny
shapes, on data without the TPU kernel's row-shift underflow, the kernel
route is also held to JAX's whole-scan ``sparse_scan_pallas.scan_scores``
in interpret mode (scores rtol 1e-5 + atol 1e-4, gradients rtol 1e-4 +
atol 1e-5: that kernel's projections are three bf16 products).  Last, ``chip_smoke.py``'s check of the sparse kernels
runs here with the kernels' plain versions standing in for them, and must
fail on a perturbed cotangent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import semiring as jax_semiring
from gtn_applications_tpu.ops import sparse as jax_sparse
from gtn_applications_tpu.ops import sparse_scan_pallas as jax_ssp
from gtn_applications_tpu_torch.ops import _build, sparse
from gtn_applications_tpu_torch.ops import seglse_pallas as slp
from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
from gtn_applications_tpu_torch.ops.semiring import NEG

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
FIELDS = ("src", "dst", "label", "weight", "start", "accept", "eps_src",
          "eps_dst", "eps_weight")


def _one_table(rng, S, A, E, C):
    """A feasible random acceptor (chain backbone, random arcs, self-loops
    at both ends) with random epsilon arcs; numpy fields."""
    src = list(range(S - 1)) + [0, S - 1]
    dst = list(range(1, S)) + [0, S - 1]
    while len(src) < A:
        src.append(int(rng.randint(0, S)))
        dst.append(int(rng.randint(0, S)))
    start = np.full(S, NEG, np.float32)
    start[0] = 0.0
    accept = np.full(S, NEG, np.float32)
    accept[S - 1] = accept[S - 2] = 0.0
    return dict(
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        label=rng.randint(0, C, A).astype(np.int32),
        weight=(rng.randn(A) * 0.5).astype(np.float32), start=start, accept=accept,
        eps_src=rng.randint(0, S, E).astype(np.int32),
        eps_dst=rng.randint(0, S, E).astype(np.int32),
        eps_weight=(rng.randn(E) * 0.5 - 1.0).astype(np.float32),
    )


def _tables(layout, B, S, A, E, C, seed):
    """Numpy fields of one table in ``layout``: 'shared' (1-D fields),
    'per_sample' ([B, ·] each) or 'union' (shared endpoints, per-sample
    labels and weights, start and accept)."""
    rng = np.random.RandomState(seed)
    if layout == "shared":
        return _one_table(rng, S, A, E, C)
    if layout == "per_sample":
        ts = [_one_table(rng, S, A, E, C) for _ in range(B)]
        return {f: np.stack([t[f] for t in ts]) for f in FIELDS}
    t = _one_table(rng, S, A, E, C)
    for f, scale in (("label", None), ("weight", 0.5), ("eps_weight", 0.5)):
        n = t[f].shape[0]
        t[f] = (rng.randint(0, C, (B, n)).astype(np.int32) if scale is None
                else (rng.randn(B, n) * scale - (f == "eps_weight")).astype(np.float32))
    t["start"] = np.tile(t["start"], (B, 1))
    t["accept"] = np.tile(t["accept"], (B, 1))
    t["weight"][1, :3] = NEG  # sample 1 lacks three of the union's arcs
    return t


def _port_table(t, depth):
    return sparse.ArcTable(**{f: torch.from_numpy(t[f]) for f in FIELDS}, eps_depth=depth)


def _jax_table(t, depth):
    return jax_sparse.ArcTable(**{f: jnp.asarray(t[f]) for f in FIELDS}, eps_depth=depth)


def _feasible_sum(scores):
    return (scores * (scores > NEG / 2)).sum()


def _port_scores(route, em, t, depth, lens):
    em_t = torch.from_numpy(em).requires_grad_(True)
    w = torch.from_numpy(t["weight"]).requires_grad_(True)
    ew = torch.from_numpy(t["eps_weight"]).requires_grad_(True)
    table = dataclasses.replace(_port_table(t, depth), weight=w, eps_weight=ew)
    scores = route(em_t, table, torch.from_numpy(lens))
    grads = torch.autograd.grad(_feasible_sum(scores), [em_t, w, ew], allow_unused=True)
    return scores.detach().numpy(), [
        (torch.zeros_like(x) if g is None else g).numpy()
        for g, x in zip(grads, [em_t, w, ew])]


def _jax_scores(em, t, depth, lens):
    def f(em, w, ew):
        table = dataclasses.replace(_jax_table(t, depth), weight=w, eps_weight=ew)
        return jax_sparse.forward_score_batch_tables(em, table, jnp.asarray(lens))

    args = (jnp.asarray(em), jnp.asarray(t["weight"]), jnp.asarray(t["eps_weight"]))
    scores = f(*args)
    grads = jax.grad(lambda *a: _feasible_sum(f(*a)), argnums=(0, 1, 2))(*args)
    return np.asarray(scores), [np.asarray(g) for g in grads]


ROUTES = {
    "plain": sparse.forward_score_batch_tables,
    "kernels": sparse._forward_batched_kernels,
}
B, T, S, A, E, C = 4, 7, 6, 20, 5, 5


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("layout", ["shared", "per_sample", "union"])
@pytest.mark.parametrize("depth", [0, 2, 3])
def test_forward_scores_match_jax(route, layout, depth):
    t = _tables(layout, B, S, A, E if depth else 0, C, seed=depth)
    rng = np.random.RandomState(10 + depth)
    em = rng.randn(B, T, C).astype(np.float32)
    # ragged, zero-length, and one frame: too short to reach an accepting
    # state of the shared chain, so that sample is infeasible there
    lens = np.asarray([T, T - 2, 0, 1], np.int32)
    scores, grads = _port_scores(ROUTES[route], em, t, depth, lens)
    j_scores, j_grads = _jax_scores(em, t, depth, lens)
    np.testing.assert_allclose(scores, j_scores, **SCORE_TOL)
    for name, a, b in zip(("dem", "dw", "deps"), grads, j_grads):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_infeasible_sample_scores_neg_without_nan():
    t = _tables("shared", B, S, A, E, C, seed=7)
    t["accept"] = np.full(S, NEG, np.float32)  # nothing accepts
    em = np.random.RandomState(8).randn(B, T, C).astype(np.float32)
    lens = np.asarray([T, 3, 0, 1], np.int32)
    for route in ROUTES.values():
        scores, grads = _port_scores(route, em, t, 2, lens)
        assert (scores <= NEG / 2).all()
        for g in grads:
            assert np.isfinite(g).all() and not g.any()


@pytest.mark.parametrize("route", list(ROUTES))
def test_single_frame(route):
    t = _tables("per_sample", B, S, A, E, C, seed=9)
    em = np.random.RandomState(9).randn(B, 1, C).astype(np.float32)
    lens = np.ones(B, np.int32)
    scores, grads = _port_scores(ROUTES[route], em, t, 2, lens)
    j_scores, j_grads = _jax_scores(em, t, 2, lens)
    np.testing.assert_allclose(scores, j_scores, **SCORE_TOL)
    for a, b in zip(grads, j_grads):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("layout,depth", [("shared", 2), ("per_sample", 0),
                                          ("union", 2)])
def test_kernel_route_matches_pallas_scan_in_interpret_mode(layout, depth):
    """JAX's whole scan (Pallas interpret mode) shifts each row by its
    largest contribution; on this data no destination lies ~80 nats below
    it, so the two agree."""
    b, t_len, s, a, e = 2, 4, 5, 12, 4
    t = _tables(layout, b, s, a, e if depth else 0, C, seed=11)
    rng = np.random.RandomState(12)
    em = rng.randn(b, t_len, C).astype(np.float32)
    lens = np.asarray([t_len, t_len - 1], np.int32)
    scores, grads = _port_scores(sparse._forward_batched_kernels, em, t, depth, lens)
    table = _jax_table(t, depth)
    as2d = lambda x: x[None] if x.ndim == 1 else x  # noqa: E731

    def f(em, w, ew):
        tb = dataclasses.replace(table, weight=w, eps_weight=ew)
        label = jnp.broadcast_to(as2d(tb.label), (b, a))
        em_arc = jax_semiring.gather_channels(em, label)
        # the start closure, per sample (JAX's segment ops take 1-D values)
        starts = jnp.broadcast_to(as2d(tb.start), (b, s))
        ews = jnp.broadcast_to(as2d(ew), (b, ew.shape[-1]))
        alpha0 = jax.vmap(lambda st, w_e: jax_sparse._eps_closure(
            st, dataclasses.replace(tb, start=st, eps_weight=w_e)))(starts, ews)
        return jax_ssp.scan_scores(
            em_arc, tuple(as2d(x) for x in (tb.src, tb.dst, tb.weight, tb.eps_src,
                                           tb.eps_dst, tb.eps_weight)),
            alpha0, as2d(tb.accept), jnp.asarray(lens), depth)

    args = (jnp.asarray(em), jnp.asarray(t["weight"]), jnp.asarray(t["eps_weight"]))
    j_scores = f(*args)
    j_grads = jax.grad(lambda *x: _feasible_sum(f(*x)), argnums=(0, 1, 2))(*args)
    np.testing.assert_allclose(scores, np.asarray(j_scores), rtol=1e-5, atol=1e-4)
    for name, x, y in zip(("dem", "dw", "deps"), grads, j_grads):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-4, atol=1e-5, err_msg=name)


def _dst_of(idx, A):
    k = torch.arange(A).expand(idx.dptr.shape[0], A).contiguous()
    return torch.searchsorted(idx.dptr[:, 1:].long().contiguous(), k, right=True)


@pytest.mark.parametrize("broken", [False, True])
def test_smoke_sparse_check_holds_kernels(monkeypatch, broken):
    """``chip_smoke.hold_sparse_kernels`` with the CUDA wrappers replaced by
    plain versions that read the arc index as the kernels do (sorted
    arcs, their destinations recovered from ``dptr``): it passes, and it
    fails when one emission cotangent is off by 1e-4 of its size."""
    import chip_smoke

    def seg_fwd(alpha, w_s, em_s, idx):
        return slp.seg_lse_fwd_plain(alpha, idx.src, _dst_of(idx, w_s.shape[1]), w_s, em_s)

    def seg_bwd(alpha, w_s, em_s, idx, g):
        return slp.seg_lse_bwd_plain(alpha, idx.src, _dst_of(idx, w_s.shape[1]), w_s,
                                     em_s, g)

    def scan_bwd(*args):
        dem, dw, deps, dalpha0 = ssp.sparse_scan_bwd_plain(*args)
        if broken:
            i = int(dem.abs().argmax())
            dem.view(-1)[i] *= 1 + 1e-4
        return dem, dw, deps, dalpha0

    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(slp, "seg_lse_fwd_cuda", seg_fwd)
    monkeypatch.setattr(slp, "seg_lse_bwd_cuda", seg_bwd)
    monkeypatch.setattr(ssp, "sparse_scan_fwd_cuda", ssp.sparse_scan_fwd_plain)
    monkeypatch.setattr(ssp, "sparse_scan_bwd_cuda", scan_bwd)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    em, table, lens = chip_smoke.random_sparse_table(torch, "cpu", 3, 12, 6, 16, 64, 12)
    check = lambda: chip_smoke.hold_sparse_kernels(  # noqa: E731
        torch, em, table, lens, "cpu", all_live=True)
    if broken:
        with pytest.raises(AssertionError, match="sparse_scan_bwd dem"):
            check()
    else:
        errs = check()
        assert errs["sparse_scan_bwd_rel"] < 1e-5 and errs["seg_lse_bwd_rel"] < 1e-5
