"""The port's transition-factored scan and bigram scorers against JAX.

``factored_scan`` of the port (its plain versions, as CPU tensors take
them) against JAX ``dense_scan_pallas.factored_scan`` (its Pallas kernels
in interpret mode off-TPU) on the same numpy-seeded lattices, at the
shapes of ``tests/test_dense_scan.py`` (one of them with N = 80): the final
alpha within atol 1e-5 + rtol 1e-5 on live states (states at NEG compare
as NEG), and the cotangents of em_state, adj_exp, wsel and ws_state under
one random cotangent of the final alpha within rtol 2e-4 + atol 2e-5.
The cases hold ragged lengths, a zero-length sample and a sample with no
start state.

Then ``factored_lattice_score`` and ``dense_ngram_norm`` of both packages,
values and gradients to em, adj, ws, W and we, against two JAX routes:
its default (the analytic-VJP fold into one frame-invariant exp-matrix
with one global shift) and its Pallas pair (``GTN_DENSE_SCAN`` on, the
per-frame per-label shift the port's scan uses).  The two JAX routes agree
with each other to rtol 1e-5 on values and rtol 2e-4 + atol 2e-5 on
gradients (``tests/test_dense_scan.py``), and so is the port held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import dense_scan_pallas as jax_dsp
from gtn_applications_tpu.ops import factored as jax_factored
from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
from gtn_applications_tpu_torch.ops import factored
from gtn_applications_tpu_torch.ops.semiring import DEAD

from tests.test_torch_dense_scan import _random_case

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _rows(rng, N):
    return [(rng.randn(*shape) * 0.3).astype(np.float32)
            for shape in ((N,), (N, N), (N,))]


@pytest.mark.parametrize("B,T,S,N", [(3, 8, 12, 6), (2, 10, 50, 9), (4, 6, 96, 80)])
def test_factored_scan_matches_jax_kernel(B, T, S, N):
    rng = np.random.RandomState(B + S + N)
    em, adj, lab, start, _, lens = _random_case(rng, B, T, S, N)
    em_state = np.einsum("btn,bsn->bts", em, lab).astype(np.float32)
    wsel = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    ws_state = (rng.randn(B, S) * 0.3).astype(np.float32)
    g = rng.randn(B, S).astype(np.float32)

    def jax_fn(e, a, w, s):
        return jax_dsp.factored_scan(e, a, w, jnp.asarray(lab), s, jnp.asarray(start),
                                     jnp.asarray(lens, jnp.float32))

    inputs = (em_state, adj, wsel, ws_state)
    j_alpha, vjp = jax.vjp(jax_fn, *[jnp.asarray(x) for x in inputs])
    j_grads = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    alpha = dsp.factored_scan(ts[0], ts[1], ts[2], torch.from_numpy(lab), ts[3],
                              torch.from_numpy(start), torch.from_numpy(lens))
    grads = torch.autograd.grad(alpha, ts, torch.from_numpy(g))

    j_alpha = np.asarray(j_alpha)
    live = j_alpha > DEAD
    np.testing.assert_array_equal(alpha.detach().numpy() > DEAD, live)
    np.testing.assert_allclose(alpha.detach().numpy()[live], j_alpha[live],
                               rtol=1e-5, atol=1e-5)
    for name, mine, theirs in zip(("em", "adj", "wsel", "ws"), grads, j_grads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), err_msg=name,
                                   **GRAD_TOL)


def test_factored_scan_skips_dadj_when_adj_needs_no_grad():
    rng = np.random.RandomState(4)
    B, T, S, N = 3, 6, 10, 5
    em, adj, lab, start, _, lens = _random_case(rng, B, T, S, N)
    args = [torch.from_numpy(x) for x in (
        np.einsum("btn,bsn->bts", em, lab), adj, (rng.randn(B, S, N) * 0.3),
        lab, (rng.randn(B, S) * 0.3), start, lens)]
    args = [a.float() if a.is_floating_point() else a for a in args]
    traj = dsp.factored_scan_fwd_plain(*args)
    rest = (args[1], args[2], args[3], args[5], args[6])
    g = torch.from_numpy(rng.randn(B, S).astype(np.float32))
    full = dsp.factored_scan_bwd_plain(traj, *rest, g)
    part = dsp.factored_scan_bwd_plain(traj, *rest, g, need_dadj=False)
    assert part[1] is None and full[1] is not None
    for a, b in zip(full[::2] + (full[3],), part[::2] + (part[3],)):
        assert torch.equal(a, b)
    e_t = args[0].clone().requires_grad_(True)
    (dem,) = torch.autograd.grad(
        dsp.factored_scan(e_t, *args[1:]), e_t, g)
    assert torch.equal(dem, full[0])


def _jax_route(route):
    """Force JAX's bigram scorer onto one route for the duration."""
    class _Ctx:
        def __enter__(self):
            self.saved = jax_factored._DENSE_SCAN_IMPL
            jax_factored._DENSE_SCAN_IMPL = "on" if route == "pallas" else "off"

        def __exit__(self, *a):
            jax_factored._DENSE_SCAN_IMPL = self.saved
    return _Ctx()


@pytest.mark.parametrize("route", ["fold", "pallas"])
@pytest.mark.parametrize("B,T,S,N", [(3, 8, 12, 6), (2, 10, 50, 9)])
def test_factored_lattice_score_matches_jax(route, B, T, S, N):
    rng = np.random.RandomState(B * 10 + S)
    em, adj, lab, start, accept, lens = _random_case(rng, B, T, S, N)
    ws, W, we = _rows(rng, N)

    def jax_score(*xs):
        return jnp.sum(jax_factored.factored_lattice_score(
            xs[0], xs[1], jnp.asarray(lab), jnp.asarray(start),
            jnp.asarray(accept), *xs[2:], jnp.asarray(lens)))

    inputs = (em, adj, ws, W, we)
    with _jax_route(route):
        j_val, j_grads = jax.value_and_grad(jax_score, argnums=tuple(range(5)))(
            *[jnp.asarray(x) for x in inputs])
        j_scores = np.asarray(jax_factored.factored_lattice_score(
            *[jnp.asarray(x) for x in (em, adj, lab, start, accept, ws, W, we, lens)]))

    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    scores = factored.factored_lattice_score(
        ts[0], ts[1], torch.from_numpy(lab), torch.from_numpy(start),
        torch.from_numpy(accept), *ts[2:], torch.from_numpy(lens))
    grads = torch.autograd.grad(scores.sum(), ts)

    np.testing.assert_allclose(scores.detach().numpy(), j_scores, rtol=1e-5, atol=1e-5)
    if B > 2:  # the zero-length sample scores the empty path, or NEG
        assert scores[1] == j_scores[1]
    for name, mine, theirs in zip(("em", "adj", "ws", "W", "we"), grads, j_grads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("ngram", [1, 2])
def test_dense_ngram_norm_and_rows_match_jax(ngram):
    rng = np.random.RandomState(ngram)
    B, T, N = 4, 9, 7
    em = rng.randn(B, T, N).astype(np.float32)
    lens = np.asarray([T, 5, 0, 1], np.int32)
    n_arcs = N if ngram == 1 else N + N * N + N + 1
    params = (rng.randn(n_arcs) * 0.3).astype(np.float32)

    def jax_norm(e, p):
        rows = jax_factored.ngram_rows(p, ngram, N)
        return jax_factored.dense_ngram_norm(e, *rows[:3], jnp.asarray(lens), rows[3])

    j_norm, vjp = jax.vjp(jax_norm, jnp.asarray(em), jnp.asarray(params))
    g = rng.randn(B).astype(np.float32)
    j_ge, j_gp = vjp(jnp.asarray(g))

    e_t = torch.from_numpy(em).requires_grad_(True)
    p_t = torch.from_numpy(params).requires_grad_(True)
    rows = factored.ngram_rows(p_t, ngram, N)
    for mine, theirs in zip(rows, jax_factored.ngram_rows(jnp.asarray(params), ngram, N)):
        np.testing.assert_array_equal(mine.detach().numpy(), np.asarray(theirs))
    norm = factored.dense_ngram_norm(e_t, *rows[:3], torch.from_numpy(lens), rows[3])
    ge, gp = torch.autograd.grad(norm, (e_t, p_t), torch.from_numpy(g))
    np.testing.assert_allclose(norm.detach().numpy(), np.asarray(j_norm),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(j_ge), **GRAD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(j_gp), **GRAD_TOL)


def _nudge_median_dwsel(bwd, rel):
    """``bwd`` with its dwsel entry nearest the median nonzero |dwsel|
    scaled by 1 + rel."""
    def nudged(*args, **kw):
        dem, dadj, dwsel, dws = bwd(*args, **kw)
        if rel:
            flat = dwsel.view(-1)
            mag = flat.abs()
            flat[int((mag - mag[mag > 0].median()).abs().argmin())] *= 1 + rel
        return dem, dadj, dwsel, dws
    return nudged


@pytest.mark.parametrize("rel", [0.0, 1e-4])
@pytest.mark.parametrize("case", ["ngram", "all_live"])
def test_smoke_factored_scan_check_holds_each_entry(monkeypatch, case, rel):
    """``chip_smoke.py``'s check of the factored kernels, with the plain
    versions standing in: it passes them as they are and fails a dwsel one
    typical entry of which is off by 1e-4 relative."""
    import chip_smoke

    monkeypatch.setattr(dsp, "factored_scan_fwd_cuda", dsp.factored_scan_fwd_plain)
    monkeypatch.setattr(dsp, "factored_scan_bwd_cuda",
                        _nudge_median_dwsel(dsp.factored_scan_bwd_plain, rel))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if case == "ngram":
        inputs = chip_smoke.factored_headline_inputs(torch, "cpu", b=4, t=30,
                                                     length=5, n=8)
    else:
        inputs = chip_smoke.factored_random_inputs(torch, "cpu", 4, 30, 24, 8)
    check = lambda: chip_smoke.hold_factored_scan_kernels(  # noqa: E731
        torch, *inputs, case, all_live=case == "all_live")
    if rel:
        with pytest.raises(AssertionError, match="dwsel: entrywise error"):
            check()
    else:
        assert check()["factored_scan_bwd_rel"] == 0.0
