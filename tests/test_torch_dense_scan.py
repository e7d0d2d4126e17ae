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
@pytest.mark.parametrize("case", ["stc", "all_live", "hub", "underflow", "word_decomps"])
def test_smoke_dense_scan_check_holds_each_dadj_entry(monkeypatch, case, rel):
    """``chip_smoke.py``'s check of the dense-scan kernels, with the plain
    versions standing in for the kernels: it passes them as they are and
    fails a dadj one typical entry of which is off by 1e-4 relative, an
    error far below a tolerance scaled by dadj's largest entry (1e6 here
    on the STC tables); on each of the smoke's cases, cut to a few
    samples and frames (the underflow case still has sums the FLT_MIN
    gate declares dead)."""
    import chip_smoke

    monkeypatch.setattr(dsp, "dense_scan_fwd_cuda", dsp.dense_scan_fwd_plain)
    monkeypatch.setattr(dsp, "dense_scan_bwd_cuda",
                        _nudge_median_entry(dsp.dense_scan_bwd_plain, rel))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if case == "stc":
        inputs = chip_smoke.stc_headline_inputs(torch, "cpu", 4, 30, 5)
    elif case == "all_live":
        inputs = chip_smoke.dense_random_inputs(torch, "cpu", 4, 30, 24)
    elif case == "hub":
        inputs = chip_smoke.dense_hub_inputs(torch, "cpu", 2, 64, 60, degree=(140, 180))
        plans = dsp.dense_plan(inputs[1], inputs[3], inputs[5])
        assert {p["route"] for p in plans} == {"shared"}  # past the registers' arcs
        assert min(p["max_in_degree"] for p in plans) >= 140
    elif case == "underflow":
        inputs = chip_smoke.dense_underflow_inputs(torch, "cpu", 4, 30)
    else:
        inputs = chip_smoke.word_decomp_inputs(torch, "cpu", 2, 30, pieces=3)
    check = lambda: chip_smoke.hold_dense_scan_kernels(  # noqa: E731
        torch, *inputs, case, all_live=case == "all_live", underflow=case == "underflow")
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


# ---------------------------------------------------------------------
# A float32 emulation of the dense kernels' algorithms (csrc/dense_scan.cu,
# "The plain dense recursion"), on the schedule
# ``dense_scan_pallas.dense_plan`` mirrors: the members (the labelled
# states in increasing u) and each one's real arcs compacted from the dense
# adjacency, a member's sum by the lanes of its round's group (lane k of a
# group of g takes every g-th arc, then the group's xor merge); the shift
# the largest alpha of the previous frame; the backward as per-frame
# statistics from traj (sh_t, rz_t = 1 / max(z, floor), 0 where z is below
# the least normal float32 and for the states without a label), the g chain by source (each source's
# adj dz[u], dz = g[u] rz[u], summed by the lanes of its group, times
# exp(traj[t-1, s] - sh_t)), and the dense dadj from the saved dz, one
# rounding more than the plain version's g / max(z, floor).  Tolerances, against the
# plain versions and against JAX's Pallas pair in interpret mode: live sets
# exactly (the shift is the TPU's, so which states underflow is decided by
# the same float32 terms, and a sum of non-negative terms is zero whatever
# its order); live values within atol 1e-4 + rtol 1e-5 (the sums run in
# another order, and alpha reaches ~100, where a float32 ulp is 7.6e-6);
# cotangents entry by entry within 1e-5 (|p| + median nonzero |p|), the
# card's criterion.  A sum below the least normal float32 is dead, as JAX's
# devices and XLA's CPU flush it to zero.
# ---------------------------------------------------------------------

FLOOR = 1e-37
TINY = torch.finfo(torch.float32).tiny


def _exp(x):
    """The kernels' exp: a result below the least normal float32 is 0."""
    e = torch.exp(x)
    return torch.where(e >= TINY, e, torch.zeros(()))


def _lane_sum(terms, g):
    """A group's sum: lane k adds terms k, k + g, ... in order, then the
    xor merge over offsets g/2 .. 1; the group's first lane's value."""
    n = -(-terms.numel() // g)
    lanes = torch.zeros(n * g, dtype=torch.float32)
    lanes[:terms.numel()] = terms
    lanes = lanes.view(n, g)
    acc = torch.zeros(g, dtype=torch.float32)
    for i in range(n):
        acc = acc + lanes[i]
    idx = torch.arange(g)
    off = g // 2
    while off:
        acc = acc + acc[idx ^ off]
        off //= 2
    return acc[0]


def _dense_compact(adj_b, has_b):
    """The prologue of one sample: the members, each member's arcs
    (sources in increasing s) and its group width (its round's,
    ``dest_rounds``); and each source's arcs into members (u, adj in member
    order) with the chain's one group width."""
    members = torch.nonzero(has_b > 0)[:, 0].tolist()
    jslot = [0 if x > 0 else -1 for x in has_b.tolist()]
    dest = [torch.nonzero(adj_b[u] != 0)[:, 0] for u in members]
    rounds, _ = dsp.dest_rounds([d.numel() for d in dest], jslot, members,
                                shift_cost=dsp.DENSE_ROUND_COST)
    g_mem = [g for m0, m1, g in rounds for _ in range(m0, m1)]
    src = [[(u, adj_b[u, s]) for u in members if adj_b[u, s] != 0]
           for s in range(adj_b.shape[0])]
    g_src = dsp.group_width(max((len(x) for x in src), default=0))
    return members, dest, g_mem, src, g_src


def _start_e(start):
    return _exp(torch.clamp(start, max=0.0)) * (start > NEG / 2)


def _sums(x, adj_b, members, dest, g_mem, sh, frame0):
    """z by member of one frame from x (e0 or alpha)."""
    z = []
    for m, u in enumerate(members):
        srcs = dest[m]
        e = x[srcs] if frame0 else _exp(x[srcs] - sh)
        z.append(_lane_sum(adj_b[u, srcs] * e, g_mem[m]))
    return z


def emulate_dense_fwd(em_state, adj, start, has_lab, lengths):
    """The forward kernel's arithmetic: traj [B, T, S], and the number of
    (frame, labelled state) pairs whose sum fell below the least normal
    float32 while one of its sources was live."""
    B, T, S = em_state.shape
    traj = torch.full((B, T, S), NEG, dtype=torch.float32)
    underflow = 0
    for b in range(B):
        members, dest, g_mem, _, _ = _dense_compact(adj[b], has_lab[b])
        t_live = max(1, min(int(lengths[b]), T))
        alpha = torch.full((S,), NEG, dtype=torch.float32)
        for t in range(t_live):
            frame0 = t == 0
            x = _start_e(start[b]) if frame0 else alpha
            # the warps' maxima of the previous frame's new alpha, or NEG
            sh = torch.zeros(()) if frame0 else torch.clamp(torch.max(alpha), min=NEG)
            z = _sums(x, adj[b], members, dest, g_mem, sh, frame0)
            new = torch.full((S,), NEG, dtype=torch.float32)
            for m, u in enumerate(members):
                if z[m] >= TINY:
                    new[u] = (em_state[b, t, u] + sh) + torch.log(torch.clamp(z[m], min=FLOOR))
                elif not frame0 and bool((alpha[dest[m]] > DEAD).any()):
                    underflow += 1
            alpha = new
            traj[b, t] = alpha
        traj[b, t_live:] = alpha
    return traj, underflow


def emulate_dense_bwd(traj, adj, start, has_lab, lengths, g_final, need_dadj=True):
    """The backward kernels' arithmetic: (dem, dadj or None)."""
    B, T, S = traj.shape
    dem = torch.zeros((B, T, S), dtype=torch.float32)
    dadj = torch.zeros_like(adj) if need_dadj else None
    for b in range(B):
        members, dest, g_mem, src, g_src = _dense_compact(adj[b], has_lab[b])
        t_live = max(1, min(int(lengths[b]), T))
        e0 = _start_e(start[b])
        # the statistics pass, off the chain
        sh, rz = {}, {}
        for t in range(t_live):
            x = e0 if t == 0 else traj[b, t - 1]
            sh[t] = torch.zeros(()) if t == 0 else torch.clamp(torch.max(x), min=NEG)
            zm = _sums(x, adj[b], members, dest, g_mem, sh[t], t == 0)
            rz[t] = torch.zeros(S, dtype=torch.float32)
            for m, u in enumerate(members):
                if zm[m] >= TINY:
                    rz[t][u] = 1.0 / torch.clamp(zm[m], min=FLOOR)
        # the chain: one sparse product by source a frame
        g = g_final[b].clone()
        dz = {}
        for t in range(t_live - 1, 0, -1):
            ga = torch.where(rz[t] > 0, g, torch.zeros(()))
            dem[b, t] = ga
            dz[t] = ga * rz[t]
            g_next = torch.zeros(S, dtype=torch.float32)
            for s, arcs in enumerate(src):
                if arcs:
                    terms = torch.stack([a * (g[u] * rz[t][u]) for u, a in arcs])
                    g_next[s] = _lane_sum(terms, g_src) * _exp(traj[b, t - 1, s] - sh[t])
            g = g_next
        ga0 = torch.where(rz[0] > 0, g, torch.zeros(()))
        dem[b, 0] = ga0
        dz[0] = ga0 * rz[0]
        if need_dadj:  # dense: every s of a labelled row, frames in decreasing t
            for u in members:
                row = torch.zeros(S, dtype=torch.float32)
                for t in range(t_live - 1, 0, -1):
                    row = row + dz[t][u] * _exp(traj[b, t - 1] - sh[t])
                dadj[b, u] = row + dz[0][u] * e0
    return dem, dadj


def _entrywise(k, p):
    a = p.abs().double()
    nz = a[a > 0]
    m = float(nz.median()) if nz.numel() else 1.0
    return float(((k - p).abs().double() / (a + m)).max())


def _dense_emulation_case(case, rng):
    """(em_state, adj, start, has_lab, lens) as numpy float32 / int32 for
    one named case; each holds a zero-length sample (1) and a sample with
    no start state (the last)."""
    if case == "all_live":
        import chip_smoke

        em_state, adj, start, has_lab, _, lens = [
            x.numpy() for x in chip_smoke.dense_random_inputs(torch, "cpu", 3, 8, 40)]
        start[-1] = NEG
    else:
        B, T, S, N = {"case0": CASES[0], "case1": CASES[1], "case2": CASES[2],
                      "hub": (3, 7, 50, 9), "underflow": (3, 8, 30, 6)}[case]
        em, adj, lab, start, _, lens = _random_case(rng, B, T, S, N)
        if case == "hub":  # one destination a sample with 40-44 sources
            for b in range(B):
                srcs = rng.choice(S, size=40 + b * 2, replace=False)
                adj[b, 5, srcs] = np.exp(rng.randn(srcs.size).clip(-3, 3))
                lab[b, 5] = 0.0
                lab[b, 5, 1] = 1.0
        em_state = np.einsum("btn,bsn->bts", em, lab).astype(np.float32)
        if case == "underflow":
            # most states' emissions 85-110 nats below the few that lead:
            # the next frame's exps of their alphas are denormal or zero
            lead = rng.rand(*em_state.shape) < 0.15
            em_state = np.where(lead, rng.randn(*em_state.shape) * 0.1,
                                -rng.uniform(85.0, 110.0, em_state.shape)).astype(np.float32)
        has_lab = (lab.sum(-1) > 0).astype(np.float32)
    lens[1] = 0
    return em_state, adj, start, has_lab, lens


@pytest.mark.parametrize("case", ["case0", "case1", "case2", "hub", "all_live", "underflow"])
def test_emulated_dense_kernels_match_plain_and_jax(case):
    rng = np.random.RandomState(len(case) + 40)
    em_state, adj, start, has_lab, lens = _dense_emulation_case(case, rng)
    t = [torch.from_numpy(x) for x in (em_state, adj, start, has_lab, lens)]
    B, T, S = em_state.shape
    plans = dsp.dense_plan(t[1], t[3], t[4])
    assert all(p["route"] != "global" for p in plans)
    if case == "hub":
        assert min(p["max_in_degree"] for p in plans) >= 40
    if case == "all_live":
        assert all(p["arcs"] == p["labelled"] * S for p in plans)

    traj, underflow = emulate_dense_fwd(*t)
    traj_p = dsp.dense_scan_fwd_plain(*t)
    live = traj_p > DEAD
    assert torch.equal(traj > DEAD, live)
    torch.testing.assert_close(traj[live], traj_p[live], atol=1e-4, rtol=1e-5)
    if case == "all_live":
        assert bool(live[0].all())  # sample 1 has no frames, sample 2 no start
    if case == "underflow":
        assert underflow > 0  # the TPU's shift decided these deaths

    g = torch.from_numpy(rng.randn(B, S).astype(np.float32))
    args = (traj_p, t[1], t[2], t[3], t[4], g)
    mine = emulate_dense_bwd(*args)
    plain = dsp.dense_scan_bwd_plain(*args)
    for name, k, p in zip(("dem", "dadj"), mine, plain):
        finite = torch.isfinite(p)
        assert torch.equal(torch.isfinite(k), finite), name
        assert _entrywise(k[finite], p[finite]) <= 1e-5, name
    assert emulate_dense_bwd(*args, need_dadj=False)[1] is None

    # JAX's Pallas pair (interpret mode): final alpha and the cotangents
    def jax_fn(e, a):
        return jax_dsp.dense_scan(e, a, jnp.asarray(start), jnp.asarray(has_lab),
                                  jnp.asarray(lens, jnp.float32))

    j_alpha, vjp = jax.vjp(jax_fn, jnp.asarray(em_state), jnp.asarray(adj))
    j_alpha = np.asarray(j_alpha)
    j_live = j_alpha > DEAD
    mine_live = traj[:, -1].numpy() > DEAD
    np.testing.assert_array_equal(mine_live, j_live)
    np.testing.assert_allclose(traj[:, -1].numpy()[j_live], j_alpha[j_live],
                               atol=1e-4, rtol=1e-5)
    j_grads = vjp(jnp.asarray(g.numpy()))
    for name, k, jg in zip(("dem", "dadj"), mine, j_grads):
        jg = torch.from_numpy(np.array(jg))
        finite = torch.isfinite(jg)
        assert _entrywise(k[finite], jg[finite]) <= 1e-5, name


@pytest.mark.parametrize("script", ["profile_dense", "profile_factored"])
def test_profile_copies_match_the_kernel_source(script):
    """Each copy the profile scripts build of ``csrc/dense_scan.cu`` (a part
    removed, or ``clock64`` marks added) still finds every piece of source
    it changes exactly once, so the scripts run on the card as they are."""
    import importlib

    mod = importlib.import_module(f"gtn_applications_tpu_torch.scripts.{script}")
    src = mod.SOURCE.read_text()
    copies = dict(mod.VARIANTS, clocks=mod.CLOCKS, chain_clocks=mod.CHAIN_CLOCKS)
    if script == "profile_factored":
        copies["round_clocks"] = mod.ROUND_CLOCKS
    for name, subs in copies.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)


def test_dense_plan_sizes_the_block_to_the_work():
    """``dense_plan``'s mirror of the kernels' schedule at the STC headline
    (S=96: 273 real arcs a sample, in-degree at most 3): three rounds of
    single lanes run on three warps with their arcs in registers and every
    emission row staged, and the chain takes one lane a source on three
    warps; at S=304 ten warps; the wrappers take S up to ``DENSE_MAX_S``."""
    import chip_smoke

    for (b, t, length), warps in (((2, 250, 30), 3), ((2, 128, 100), 10)):
        _, adj, _, has_lab, _, il = chip_smoke.stc_headline_inputs(torch, "cpu", b, t, length)
        for plan in dsp.dense_plan(adj, has_lab, il):
            assert plan["rounds"] == plan["warps"] == plan["chain_warps"] == warps
            assert plan["max_in_degree"] <= 3 and plan["max_out_degree"] <= 3
            assert (plan["route"], plan["rows"], plan["chain_route"], plan["chain_group"]) == (
                "registers", "staged", "registers", 1)
    assert dsp.dense_fits(376) and dsp.dense_fits(dsp.DENSE_MAX_S)
    assert not dsp.dense_fits(dsp.DENSE_MAX_S + 1)
    assert dsp._dense_scratch_words(2, 10, 96, False) == 2 * 10 * 97 + 2 * 96
