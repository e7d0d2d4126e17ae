"""The port's dense-adjacency scan against the JAX package.

``dense_scan`` of the port (its plain versions, as CPU tensors take them)
against JAX ``dense_scan_pallas.dense_scan`` (its Pallas kernels in
interpret mode off-TPU) on the same numpy-seeded lattices: the final alpha,
and the cotangents of em_state and adj_exp under one random cotangent of
the final alpha.  Then ``alignment_lattice_score`` of both packages on
their default paths (JAX: the analytic-VJP scan): the scores and the
gradients with respect to the emissions and the adjacency.  Cases include
ragged lengths, a zero-length sample and a fully dead sample (no start
state), on which both packages must give the same finite values.

Tolerances: values atol 1e-5 + rtol 1e-5 on live states (states at NEG
compare exactly as NEG); cotangents atol 1e-5 + rtol 1e-4 (fp32 matvecs
summed in another order by the two libraries, over up to 12 frames).

The kernels themselves run only on the card, where ``chip_smoke.py``
holds them against these plain versions; here that check is itself
tested, with the plain versions standing in for the kernels.
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
from gtn_applications_tpu_torch.ops.semiring import DEAD, NEG


def _random_case(rng, B, T, S, N):
    """Every state has one in-label; adjacency from exp of bounded weights
    with random sparsity; start / accept on random subsets.  Sample 1 has
    length 0 (when B > 2) and the last sample has no start state."""
    adj = np.where(rng.rand(B, S, S) < 0.3,
                   np.exp(rng.randn(B, S, S).clip(-3, 3)), 0.0).astype(np.float32)
    lab = np.zeros((B, S, N), np.float32)
    labels = rng.randint(0, N, size=(B, S))
    has = rng.rand(B, S) < 0.9
    lab[np.nonzero(has) + (labels[has],)] = 1.0
    start = np.where(rng.rand(B, S) < 0.4, 0.0, NEG).astype(np.float32)
    start[-1] = NEG
    accept = np.where(rng.rand(B, S) < 0.4, rng.randn(B, S) * 0.1,
                      NEG).astype(np.float32)
    em = rng.randn(B, T, N).astype(np.float32)
    lens = rng.randint(1, T + 1, size=(B,)).astype(np.int32)
    lens[0] = T
    if B > 2:
        lens[1] = 0
    return em, adj, lab, start, accept, lens


CASES = [(3, 7, 10, 6), (2, 12, 40, 9), (4, 5, 33, 5)]


@pytest.mark.parametrize("B,T,S,N", CASES)
def test_dense_scan_matches_jax_kernel(B, T, S, N):
    rng = np.random.RandomState(B * 100 + S)
    em, adj, lab, start, _, lens = _random_case(rng, B, T, S, N)
    em_state = np.einsum("btn,bsn->bts", em, lab).astype(np.float32)
    has_lab = (lab.sum(-1) > 0).astype(np.float32)
    g = rng.randn(B, S).astype(np.float32)

    def jax_fn(e, a):
        return jax_dsp.dense_scan(e, a, jnp.asarray(start), jnp.asarray(has_lab),
                                  jnp.asarray(lens, jnp.float32))

    j_alpha, vjp = jax.vjp(jax_fn, jnp.asarray(em_state), jnp.asarray(adj))
    j_dem, j_dadj = vjp(jnp.asarray(g))

    e_t = torch.from_numpy(em_state).requires_grad_(True)
    a_t = torch.from_numpy(adj).requires_grad_(True)
    alpha = dsp.dense_scan(e_t, a_t, torch.from_numpy(start),
                           torch.from_numpy(has_lab), torch.from_numpy(lens))
    dem, dadj = torch.autograd.grad(alpha, (e_t, a_t), torch.from_numpy(g))

    j_alpha = np.asarray(j_alpha)
    live = j_alpha > DEAD
    np.testing.assert_array_equal(alpha.detach().numpy() > DEAD, live)
    np.testing.assert_allclose(alpha.detach().numpy()[live], j_alpha[live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dem.numpy(), np.asarray(j_dem), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dadj.numpy(), np.asarray(j_dadj), rtol=1e-4, atol=1e-5)


def test_dense_scan_skips_dadj_when_adj_needs_no_grad():
    rng = np.random.RandomState(7)
    em, adj, lab, start, _, lens = _random_case(rng, 3, 6, 12, 5)
    em_state = torch.from_numpy(np.einsum("btn,bsn->bts", em, lab))
    has_lab = torch.from_numpy((lab.sum(-1) > 0).astype(np.float32))
    args = (torch.from_numpy(adj), torch.from_numpy(start), has_lab,
            torch.from_numpy(lens))
    traj = dsp.dense_scan_fwd_plain(em_state, *args)
    g = torch.from_numpy(rng.randn(3, 12).astype(np.float32))
    dem, dadj = dsp.dense_scan_bwd_plain(traj, *args, g, need_dadj=False)
    dem_full, dadj_full = dsp.dense_scan_bwd_plain(traj, *args, g)
    assert dadj is None and dadj_full is not None
    assert torch.equal(dem, dem_full)

    e_t = em_state.clone().requires_grad_(True)
    (dem_ag,) = torch.autograd.grad(dsp.dense_scan(e_t, *args), e_t, g)
    assert torch.equal(dem_ag, dem)


def _nudge_median_entry(bwd, rel):
    """``bwd`` with its dadj entry nearest the median nonzero |dadj| scaled
    by 1 + rel."""
    def nudged(*args, **kw):
        dem, dadj = bwd(*args, **kw)
        if dadj is not None and rel:
            flat = dadj.view(-1)
            mag = flat.abs()
            flat[int((mag - mag[mag > 0].median()).abs().argmin())] *= 1 + rel
        return dem, dadj
    return nudged


@pytest.mark.parametrize("rel", [0.0, 1e-4])
@pytest.mark.parametrize("case", ["stc", "all_live"])
def test_smoke_dense_scan_check_holds_each_dadj_entry(monkeypatch, case, rel):
    """``chip_smoke.py``'s check of the dense-scan kernels, with the plain
    versions standing in for the kernels: it passes them as they are and
    fails a dadj one typical entry of which is off by 1e-4 relative, an
    error far below a tolerance scaled by dadj's largest entry (1e6 here
    on the STC tables)."""
    import chip_smoke

    monkeypatch.setattr(dsp, "dense_scan_fwd_cuda", dsp.dense_scan_fwd_plain)
    monkeypatch.setattr(dsp, "dense_scan_bwd_cuda",
                        _nudge_median_entry(dsp.dense_scan_bwd_plain, rel))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if case == "stc":
        inputs = chip_smoke.stc_headline_inputs(torch, "cpu", 4, 30, 5)
    else:
        inputs = chip_smoke.dense_random_inputs(torch, "cpu", 4, 30, 24)
    check = lambda: chip_smoke.hold_dense_scan_kernels(  # noqa: E731
        torch, *inputs, case, all_live=case == "all_live")
    if rel:
        with pytest.raises(AssertionError, match="dadj: entrywise error"):
            check()
    else:
        assert check()["dense_scan_bwd_rel"] == 0.0


@pytest.mark.parametrize("B,T,S,N", CASES)
def test_alignment_lattice_score_matches_jax(B, T, S, N):
    rng = np.random.RandomState(B + S + N)
    em, adj, lab, start, accept, lens = _random_case(rng, B, T, S, N)

    def jax_score(e, a):
        return jnp.sum(jax_factored.alignment_lattice_score(
            e, a, jnp.asarray(lab), jnp.asarray(start), jnp.asarray(accept),
            jnp.asarray(lens)))

    j_scores = np.asarray(jax_factored.alignment_lattice_score(
        jnp.asarray(em), jnp.asarray(adj), jnp.asarray(lab), jnp.asarray(start),
        jnp.asarray(accept), jnp.asarray(lens)))
    j_ge, j_ga = jax.grad(jax_score, argnums=(0, 1))(jnp.asarray(em),
                                                      jnp.asarray(adj))

    e_t = torch.from_numpy(em).requires_grad_(True)
    a_t = torch.from_numpy(adj).requires_grad_(True)
    scores = factored.alignment_lattice_score(
        e_t, a_t, torch.from_numpy(lab), torch.from_numpy(start),
        torch.from_numpy(accept), torch.from_numpy(lens))
    ge, ga = torch.autograd.grad(scores.sum(), (e_t, a_t))

    np.testing.assert_allclose(scores.detach().numpy(), j_scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(j_ge), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ga.numpy(), np.asarray(j_ga), rtol=1e-4, atol=1e-5)
    if B > 2:  # the zero-length sample scores the empty path, or NEG
        assert scores[1] == j_scores[1]
    assert np.all(np.isfinite(ge.numpy())) and np.all(np.isfinite(ga.numpy()))
