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
from gtn_applications_tpu_torch.ops.semiring import DEAD, NEG

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
@pytest.mark.parametrize("case", ["ngram", "all_live", "underflow"])
def test_smoke_factored_scan_check_holds_each_entry(monkeypatch, case, rel):
    """``chip_smoke.py``'s check of the factored kernels, with the plain
    versions standing in: it passes them as they are and fails a dwsel one
    typical entry of which is off by 1e-4 relative (the underflow case cut
    to 4 samples and 30 frames, with sums the FLT_MIN gate declares dead)."""
    import chip_smoke

    monkeypatch.setattr(dsp, "factored_scan_fwd_cuda", dsp.factored_scan_fwd_plain)
    monkeypatch.setattr(dsp, "factored_scan_bwd_cuda",
                        _nudge_median_dwsel(dsp.factored_scan_bwd_plain, rel))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if case == "ngram":
        inputs = chip_smoke.factored_headline_inputs(torch, "cpu", b=4, t=30,
                                                     length=5, n=8)
    elif case == "all_live":
        inputs = chip_smoke.factored_random_inputs(torch, "cpu", 4, 30, 24, 8)
    else:
        inputs = chip_smoke.factored_underflow_inputs(torch, "cpu", b=4, t=30)
    check = lambda: chip_smoke.hold_factored_scan_kernels(  # noqa: E731
        torch, *inputs, case, all_live=case == "all_live", underflow=case == "underflow")
    if rel:
        with pytest.raises(AssertionError, match="dwsel: entrywise error"):
            check()
    else:
        assert check()["factored_scan_bwd_rel"] == 0.0


# ---------------------------------------------------------------------
# A float32 emulation of the CUDA kernels' algorithms (csrc/dense_scan.cu),
# on the schedule ``dense_scan_pallas.factored_plan`` mirrors: the arcs
# compacted from the dense adjacency by destination in member order, each
# slot's shift over all S states, each member's sum by lanes matched to its
# in-degree (lane k of a group of g takes every g-th arc, then the group's
# xor merge); the backward as per-frame statistics from traj, the g chain
# by source with each arc's dwsel sum in frame order, and the dense dadj
# from the saved dz, where dz = g (1 / max(z, floor)), the reciprocal taken
# once a frame and state off the chain (one rounding more than the plain
# version's g / max(z, floor)).  Tolerances, each against the plain
# versions and JAX:
# live sets exactly (the shift is the TPU's, so which states underflow is
# decided by the same float32 terms, and a sum of non-negative terms is
# zero whatever its order); live values within atol 1e-4 + rtol 1e-5 (the
# sums run in another order, and alpha reaches ~100, where a float32 ulp is
# 7.6e-6); cotangents entry by entry within 1e-5 (|p| + median nonzero
# |p|), the card's criterion, and against JAX within GRAD_TOL (JAX's
# Pallas pair in interpret mode).  A sum below the least normal float32 is
# dead, as JAX's devices and XLA's CPU flush it to zero.
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


def _compact(adj_b, lab_b):
    """The prologue's compaction of one sample: label slots, members, each
    member's arcs (sources in increasing s) and its group width (its
    round's, ``dest_rounds``); and each source's arcs into members (member
    order: u, slot, adj) with the chain's one group width."""
    label_of, jslot, members = dsp.compact_members(lab_b)
    dest = [torch.nonzero(adj_b[u] != 0)[:, 0] for u in members]
    rounds, _ = dsp.dest_rounds([d.numel() for d in dest], jslot, members)
    g_mem = [g for m0, m1, g in rounds for _ in range(m0, m1)]
    src = []
    for s in range(adj_b.shape[0]):
        src.append([(u, jslot[u], adj_b[u, s]) for u in members if adj_b[u, s] != 0])
    g_src = dsp.group_width(max((len(x) for x in src), default=0))
    return label_of, jslot, members, dest, g_mem, src, g_src


def _start_e(start):
    return _exp(torch.clamp(start, max=0.0)) * (start > NEG / 2)


def _frame_stats(x, adj_b, wt, members, jslot, dest, g_mem, frame0):
    """(sh by slot, z by member) of one frame from x (e0 or alpha)."""
    sh = {}
    if not frame0:
        for j in range(wt.shape[0]):
            sh[j] = torch.clamp(torch.max(x + wt[j]), min=NEG)
    z = []
    for m, u in enumerate(members):
        j, srcs = jslot[u], dest[m]
        a = adj_b[u, srcs]
        e = x[srcs] if frame0 else _exp((x[srcs] + wt[j, srcs]) - sh[j])
        z.append(_lane_sum(a * e, g_mem[m]))
    return sh, z


def emulate_fwd(em_state, adj, wsel, lab_oh, ws_state, start, lengths):
    """The forward kernel's arithmetic: traj [B, T, S], and the number of
    (frame, labelled state) pairs whose sum underflowed to 0 while one of
    its sources was live."""
    B, T, S = em_state.shape
    lab_idx = dsp.label_index(lab_oh)
    traj = torch.full((B, T, S), NEG, dtype=torch.float32)
    underflow = 0
    for b in range(B):
        label_of, jslot, members, dest, g_mem, _, _ = _compact(adj[b], lab_idx[b])
        wt = wsel[b][:, label_of].T.contiguous() if label_of else wsel[b][:, :0].T
        t_live = max(1, min(int(lengths[b]), T))
        alpha = torch.full((S,), NEG, dtype=torch.float32)
        for t in range(t_live):
            frame0 = t == 0
            x = _start_e(start[b]) if frame0 else alpha
            sh, z = _frame_stats(x, adj[b], wt, members, jslot, dest, g_mem, frame0)
            new = torch.full((S,), NEG, dtype=torch.float32)
            for m, u in enumerate(members):
                zu = z[m]
                if frame0:
                    new[u] = ((em_state[b, 0, u] + ws_state[b, u]) + torch.log(
                        torch.clamp(zu, min=FLOOR))) if zu >= TINY else NEG
                else:
                    new[u] = em_state[b, t, u] + ((sh[jslot[u]] + torch.log(
                        torch.clamp(zu, min=FLOOR))) if zu >= TINY else NEG)
                    if zu < TINY and bool((alpha[dest[m]] > DEAD).any()):
                        underflow += 1
            alpha = new
            traj[b, t] = alpha
        traj[b, t_live:] = alpha
    return traj, underflow


def emulate_bwd(traj, adj, wsel, lab_oh, start, lengths, g_final, need_dadj=True):
    """The backward kernels' arithmetic: (dem, dadj or None, dwsel, dws)."""
    B, T, S = traj.shape
    N = wsel.shape[2]
    lab_idx = dsp.label_index(lab_oh)
    dem = torch.zeros((B, T, S), dtype=torch.float32)
    dadj = torch.zeros_like(adj) if need_dadj else None
    dwsel = torch.zeros((B, S, N), dtype=torch.float32)
    dws = torch.zeros((B, S), dtype=torch.float32)
    for b in range(B):
        label_of, jslot, members, dest, g_mem, src, g_src = _compact(adj[b], lab_idx[b])
        wt = wsel[b][:, label_of].T.contiguous() if label_of else wsel[b][:, :0].T
        lab = torch.tensor([j >= 0 for j in jslot])
        t_live = max(1, min(int(lengths[b]), T))
        e0 = _start_e(start[b])
        # the statistics pass, off the chain
        stats = {}
        for t in range(t_live):
            x = e0 if t == 0 else traj[b, t - 1]
            sh, zm = _frame_stats(x, adj[b], wt, members, jslot, dest, g_mem, t == 0)
            rz = torch.zeros(S, dtype=torch.float32)  # 1 / max(z, floor), 0 below FLT_MIN
            for m, u in enumerate(members):
                rz[u] = 1.0 / torch.clamp(zm[m], min=FLOOR) if zm[m] >= TINY else 0.0
            stats[t] = (sh, rz)
        # the chain: one sparse product by source a frame
        g = g_final[b].clone()
        acc = [[torch.zeros((), dtype=torch.float32) for _ in arcs] for arcs in src]
        dz = {}
        for t in range(t_live - 1, 0, -1):
            sh, rz = stats[t]
            ga = torch.where(lab, g, torch.zeros(()))
            dem[b, t] = ga
            dz[t] = torch.where(lab, ga * rz, torch.zeros(()))
            g_next = torch.zeros(S, dtype=torch.float32)
            for s, arcs in enumerate(src):
                if not arcs:
                    continue
                terms = []
                for k, (u, j, a) in enumerate(arcs):
                    e = _exp((traj[b, t - 1, s] + wt[j, s]) - sh[j])
                    term = (a * (g[u] * rz[u])) * e
                    terms.append(term)
                    acc[s][k] = acc[s][k] + term
                g_next[s] = _lane_sum(torch.stack(terms), g_src)
            g = g_next
        _, rz0 = stats[0]
        ga0 = torch.where(lab & (rz0 > 0), g, torch.zeros(()))
        dem[b, 0] = dws[b] = ga0
        dz[0] = torch.where(lab, ga0 * rz0, torch.zeros(()))
        # dwsel: each source's arcs run by slot, summed once
        for s, arcs in enumerate(src):
            k = 0
            while k < len(arcs):
                j, total = arcs[k][1], torch.zeros((), dtype=torch.float32)
                while k < len(arcs) and arcs[k][1] == j:
                    total = total + acc[s][k]
                    k += 1
                dwsel[b, s, label_of[j]] = total
        if need_dadj:  # dense: every s of a labelled row, frames in decreasing t
            for u in members:
                j, row = jslot[u], torch.zeros(S, dtype=torch.float32)
                for t in range(t_live - 1, 0, -1):
                    row = row + dz[t][u] * _exp(
                        (traj[b, t - 1] + wt[j]) - stats[t][0][j])
                dadj[b, u] = row + dz[0][u] * e0
    return dem, dadj, dwsel, dws


def _entrywise(k, p):
    a = p.abs().double()
    nz = a[a > 0]
    m = float(nz.median()) if nz.numel() else 1.0
    return float(((k - p).abs().double() / (a + m)).max())


def _emulation_case(case, rng):
    """Inputs (em_state, adj, wsel, lab_oh, ws_state, start, lengths) as
    numpy float32 / int32 for one named case."""
    if case == "all_live":
        import chip_smoke

        xs = chip_smoke.factored_random_inputs(torch, "cpu", 3, 8, 40, 8)
        em_state, adj, wsel, lab, ws_state, start, _, lens = [x.numpy() for x in xs]
        return em_state, adj, wsel, lab, ws_state, start, lens
    B, T, S, N = {"small": (3, 8, 12, 6), "mid": (2, 10, 50, 9), "wide_n": (4, 6, 96, 80),
                  "hub": (3, 7, 50, 9), "underflow": (3, 8, 30, 6)}[case]
    em, adj, lab, start, _, lens = _random_case(rng, B, T, S, N)
    wsel = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    if case == "hub":  # one destination a sample with 40-45 sources
        for b in range(B):
            srcs = rng.choice(S, size=40 + b * 2, replace=False)
            adj[b, 5, srcs] = np.exp(rng.randn(srcs.size).clip(-3, 3))
            lab[b, 5] = 0.0
            lab[b, 5, 1] = 1.0
    if case == "underflow":
        # each label's weights from most sources 85-110 nats below the few
        # that lead it: their exps are denormal or zero after the shift
        lead = rng.rand(B, S, N) < 0.15
        wsel = np.where(lead, 0.0, -rng.uniform(85.0, 110.0, (B, S, N))).astype(np.float32)
        em = (rng.randn(*em.shape) * 0.1).astype(np.float32)
    em_state = np.einsum("btn,bsn->bts", em, lab).astype(np.float32)
    ws_state = (rng.randn(B, S) * 0.3).astype(np.float32)
    return em_state, adj, wsel, lab, ws_state, start, lens


@pytest.mark.parametrize("case", ["small", "mid", "wide_n", "hub", "all_live", "underflow"])
def test_emulated_kernels_match_plain_and_jax(case):
    rng = np.random.RandomState(len(case))
    em_state, adj, wsel, lab, ws_state, start, lens = _emulation_case(case, rng)
    t = [torch.from_numpy(x) for x in (em_state, adj, wsel, lab, ws_state, start, lens)]
    B, T, S = em_state.shape
    plans = dsp.factored_plan(t[1], dsp.label_index(t[3]), t[6], wsel.shape[2])
    if case == "hub":
        assert min(p["max_in_degree"] for p in plans) > 32
    if case == "all_live":
        assert all(p["arcs"] == p["labelled"] * S for p in plans)

    traj, underflow = emulate_fwd(*t)
    traj_p = dsp.factored_scan_fwd_plain(*t)
    live = traj_p > DEAD
    assert torch.equal(traj > DEAD, live)
    torch.testing.assert_close(traj[live], traj_p[live], atol=1e-4, rtol=1e-5)
    if case == "all_live":
        assert bool(live.all())
    if case == "underflow":
        assert underflow > 0  # the TPU's shift decided these deaths

    g = torch.from_numpy(rng.randn(B, S).astype(np.float32))
    args = (traj_p, t[1], t[2], t[3], t[5], t[6], g)
    mine = emulate_bwd(*args)
    plain = dsp.factored_scan_bwd_plain(*args)
    for name, k, p in zip(("dem", "dadj", "dwsel", "dws"), mine, plain):
        finite = torch.isfinite(p)
        assert torch.equal(torch.isfinite(k), finite), name
        assert _entrywise(k[finite], p[finite]) <= 1e-5, name
    assert emulate_bwd(*args, need_dadj=False)[1] is None

    # JAX's Pallas pair (interpret mode): final alpha and the cotangents
    def jax_fn(e, a, w, s):
        return jax_dsp.factored_scan(e, a, w, jnp.asarray(lab), s, jnp.asarray(start),
                                     jnp.asarray(lens, jnp.float32))

    j_alpha, vjp = jax.vjp(jax_fn, *[jnp.asarray(x) for x in (em_state, adj, wsel, ws_state)])
    j_alpha = np.asarray(j_alpha)
    j_live = j_alpha > DEAD
    mine_live = traj[:, -1].numpy() > DEAD
    np.testing.assert_array_equal(mine_live, j_live)
    np.testing.assert_allclose(traj[:, -1].numpy()[j_live], j_alpha[j_live],
                               atol=1e-4, rtol=1e-5)
    j_grads = vjp(jnp.asarray(g.numpy()))
    for name, k, jg in zip(("dem", "dadj", "dwsel", "dws"), mine, j_grads):
        jg = np.asarray(jg)
        finite = np.isfinite(jg)
        np.testing.assert_allclose(k.numpy()[finite], jg[finite], err_msg=name, **GRAD_TOL)
