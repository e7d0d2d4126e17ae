"""The port's ``seg_lse`` (one sparse-lattice step) against the JAX package.

On CPU tensors the port's ``ops.seglse_pallas.seg_lse`` runs its plain
version (the CUDA pair runs on the card, where ``chip_smoke.py`` holds it
against this plain version).  It is held to JAX's Pallas ``seg_lse`` (in
interpret mode, as ``tests/test_seglse.py`` runs it) within rtol 1e-5 +
atol 1e-5 on values and rtol 1e-5 + atol 1e-6 on the VJP (dalpha, dw,
dem), with shared, per-sample and mixed batch dims and both kinds of
padding arcs (the port's ``src=0, dst=S-1, w=NEG`` and JAX's -1
endpoints), on data in which every destination is live.  Where states are
dead, the port masks them as JAX's plain ``segment_logsumexp`` does (the
Pallas kernel does not), so there it is held to that function's VJP.  The
arc index that the CUDA kernels walk is checked against the arcs it
groups.  The CUDA kernels' schedule is emulated in float32 (lane
groups matched to degree, hub warps, the by-source backward from the
forward's saved shifts and sums, reads through the index) and held to
the plain versions and to JAX; the wrapper's CUDA route, forced with
plain stand-ins, must launch once a step and gather nothing into the
sorted order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import seglse_pallas as jax_seglse
from gtn_applications_tpu.ops import semiring as jax_semiring
from gtn_applications_tpu_torch.ops import _build
from gtn_applications_tpu_torch.ops import seglse_pallas as slp
from gtn_applications_tpu_torch.ops.semiring import DEAD, NEG

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _arcs(rng, rows, S, A, pad):
    """[rows, A] arcs in which every destination has an arc from a random
    source, then random arcs, then ``pad`` padding arcs."""
    n = A - pad
    src = rng.randint(0, S, (rows, n))
    dst = np.concatenate([np.tile(np.arange(S), (rows, 1)),
                          rng.randint(0, S, (rows, n - S))], axis=1)
    w = rng.randn(rows, n).astype(np.float32) * 0.5
    return src, dst, w


def _case(layout, padding, B=3, S=7, A=30, pad=4, seed=0):
    """alpha [B, S]; src, dst, w, em with the batch dims ``layout`` names
    (for src/dst, w, em: 's' shared, 'b' per sample)."""
    rng = np.random.RandomState(seed)
    rows = {"s": 1, "b": B}
    r_sd, r_w, r_em = (rows[c] for c in layout)
    src, dst, _ = _arcs(rng, r_sd, S, A, pad)
    w = rng.randn(r_w, A - pad).astype(np.float32) * 0.5
    em = rng.randn(r_em, A - pad).astype(np.float32)
    if padding == "port":  # wfst.compile.to_arc_table's padding arcs
        ps, pd, pw = 0, S - 1, NEG
    else:  # the JAX kernel's own -1 endpoints
        ps, pd, pw = -1, -1, NEG
    src = np.concatenate([src, np.full((r_sd, pad), ps)], 1).astype(np.int32)
    dst = np.concatenate([dst, np.full((r_sd, pad), pd)], 1).astype(np.int32)
    w = np.concatenate([w, np.full((r_w, pad), pw, np.float32)], 1)
    em = np.concatenate([em, np.zeros((r_em, pad), np.float32)], 1)
    alpha = rng.randn(B, S).astype(np.float32)
    g = rng.rand(B, S).astype(np.float32)
    return alpha, src, dst, w, em, g


def _port(alpha, src, dst, w, em, g):
    t = [torch.from_numpy(x) for x in (alpha, w, em)]
    for x in t:
        x.requires_grad_(True)
    out = slp.seg_lse(t[0], torch.from_numpy(src), torch.from_numpy(dst), t[1], t[2])
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("padding", ["port", "jax"])
@pytest.mark.parametrize("layout", ["sss", "bbb", "sbb", "bss", "sbs"])
def test_seg_lse_matches_pallas(layout, padding):
    alpha, src, dst, w, em, g = _case(layout, padding)
    out, grads = _port(alpha, src, dst, w, em, g)

    def f(alpha, w, em):
        return jax_seglse.seg_lse(alpha, jnp.asarray(src), jnp.asarray(dst), w, em)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (alpha, w, em)))
    j_grads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(j_out), **VALUE_TOL)
    for name, a, b in zip(("dalpha", "dw", "dem"), grads, j_grads):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **GRAD_TOL)


def test_seg_lse_masks_dead_states_as_segment_logsumexp():
    """Dead sources, a destination reached only through dead arcs and one
    reached by no arc: values and VJP of JAX's masked plain step."""
    rng = np.random.RandomState(4)
    B, S, A = 2, 6, 16
    alpha = rng.randn(B, S).astype(np.float32)
    alpha[:, 1] = NEG
    src = rng.randint(0, S, (B, A)).astype(np.int32)
    dst = rng.randint(0, S - 2, (B, A)).astype(np.int32)
    src[:, :3], dst[:, :3] = 1, S - 2  # S-2: only from the dead state 1
    w = rng.randn(B, A).astype(np.float32)
    em = rng.randn(B, A).astype(np.float32)
    g = rng.rand(B, S).astype(np.float32)
    out, grads = _port(alpha, src, dst, w, em, g)

    def f(alpha, w, em):
        contrib = jax.vmap(lambda a, s: a[s])(alpha, jnp.asarray(src)) + w + em
        return jax.vmap(lambda c, d: jax_semiring.segment_logsumexp(c, d, S))(
            contrib, jnp.asarray(dst))

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (alpha, w, em)))
    j_grads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(j_out), **VALUE_TOL)
    assert (out[:, S - 2:] == NEG).all()
    for name, a, b in zip(("dalpha", "dw", "dem"), grads, j_grads):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **GRAD_TOL)
    assert (grads[1][:, :3] == 0).all()


@pytest.mark.parametrize("rows", [1, 3])
def test_arc_index_groups_every_arc(rows):
    """The index the CUDA kernels walk: arcs sorted by destination (those
    without one last), each source's and each label's arcs listed once."""
    rng = np.random.RandomState(5)
    S, C, A = 9, 4, 40
    src = torch.from_numpy(rng.randint(-1, S, (rows, A)).astype(np.int32))
    dst = torch.from_numpy(rng.randint(-1, S + 1, (rows, A)).astype(np.int32))
    label = torch.from_numpy(rng.randint(0, C + 1, (rows, A)).astype(np.int32))
    idx = slp.arc_index(src, dst, S, label, C)
    for r in range(rows):
        order = idx.order[r].numpy()
        assert sorted(order) == list(range(A))
        d_sorted = dst[r].numpy()[order]
        ptr = idx.dptr[r].numpy()
        for s in range(S):
            assert (d_sorted[ptr[s]:ptr[s + 1]] == s).all()
        assert not ((d_sorted[ptr[S]:] >= 0) & (d_sorted[ptr[S]:] < S)).any()
        for field, ptr_, grp, n, ref in (
                ("src", idx.sptr, idx.sorder, S, src), ("label", idx.lptr, idx.lorder, C,
                                                         label)):
            sorted_ref = ref[r].numpy()[order]
            p, o = ptr_[r].numpy(), grp[r].numpy()
            listed = []
            for v in range(n):
                members = o[p[v]:p[v + 1]]
                assert (sorted_ref[members] == v).all(), field
                listed.extend(members.tolist())
            valid = np.nonzero((sorted_ref >= 0) & (sorted_ref < n))[0]
            assert sorted(listed) == valid.tolist(), field
            assert (getattr(idx, field)[r].numpy()
                    == np.where((sorted_ref >= 0) & (sorted_ref < n), sorted_ref, -1)).all()


def test_take_and_untake_are_inverse():
    rng = np.random.RandomState(6)
    order = torch.from_numpy(np.stack([rng.permutation(7) for _ in range(3)]))
    x = torch.from_numpy(rng.randn(3, 7).astype(np.float32))
    assert torch.equal(slp.untake(slp.take(x, order), order), x)
    shared = torch.from_numpy(rng.randn(1, 7).astype(np.float32))
    out = slp.take(shared, order)
    assert out.shape == (3, 7)
    assert torch.equal(slp.untake(out, order), shared.expand(3, 7))


# ---------------------------------------------------------------------------
# The CUDA kernels' schedule, emulated in float32
# ---------------------------------------------------------------------------
#
# ``csrc/sparse_scan.cu`` seg_lse_fwd_kernel / seg_lse_bwd_kernel: a block
# of 256 threads takes 256 rows (destinations forward, sources backward),
# a warp lays its 32 rows out on lane positions in groups of 1-32 lanes
# (powers of two) matched to the row's degree (8 arcs a lane), widest
# first, and runs 32 positions a pass; a hub of more than 256 arcs goes to
# the block's warps without rows (all, where every warp has some), 8 arcs
# a thread in registers and further rounds past that, its warps' maxima and
# then sums meeting in warp order.  The forward reads w and em at each
# arc's original id (``idx.arc``) and saves each destination's shift and
# sum; the backward walks the by-source order (``sptr``, ``sarc``,
# ``sdst``) from them.  The emulation follows the same lanes, passes and
# summation orders (numpy's float32 exp/log stand in for the card's
# expf/logf).

F32 = np.float32
THREADS, LANE_ARCS, WIDTHS = 256, 8, (32, 16, 8, 4, 2, 1)
LANES = np.arange(32)


def _width(n):
    if n == 0:
        return 0
    return next((g for g in WIDTHS[::-1] if n <= g * LANE_ARCS), -1)


def _xor_reduce(v, g, op):
    """The xor-shuffle tree over aligned groups of g lanes (g per lane,
    or one for all) of v [..., 32]."""
    g = np.broadcast_to(g, (32,))
    for off in (16, 8, 4, 2, 1):
        v = np.where(off < g, op(v, v[..., LANES ^ off]), v).astype(F32)
    return v


def _warp(ptr, r0, n_rows):
    """The passes of the warp whose rows are r0..r0+31 (``warp_rows``):
    (own row per lane or -1, first position, end, width, place in group)
    per pass; the warp's hub rows in lane order; whether it has rows."""
    rows = r0 + LANES
    ok = rows < n_rows
    last = np.minimum(rows, n_rows - 1)
    beg, end = np.where(ok, ptr[last], 0), np.where(ok, ptr[last + 1], 0)
    w = np.array([_width(n) for n in end - beg])
    order = np.concatenate([LANES[w == g] for g in WIDTHS])  # rows, widest first
    widths = np.repeat(WIDTHS, [(w == g).sum() for g in WIDTHS])
    starts = np.concatenate([[0], np.cumsum(widths)])
    passes = []
    for p0 in range(0, starts[-1], 32):
        p = p0 + LANES
        i = np.searchsorted(starts, p, side="right") - 1
        live = p < starts[-1]
        i = np.where(live, i, 0)
        lane = np.where(live, order[i] if order.size else 0, -1)
        g = np.where(live, widths[i] if order.size else 1, 1)
        sub = np.where(live, p - starts[i], 0)
        passes.append((np.where(lane >= 0, r0 + lane, -1), np.where(lane >= 0, beg[lane], 0),
                       np.where(lane >= 0, end[lane], 0), g, sub))
    return passes, rows[w == -1], bool((w > 0).any())


def _blocks(ptr, n_rows):
    """Per block: each warp's passes, the block's hubs and the threads'
    hub positions (``hubs_pending``: the warps without rows take them)."""
    out = []
    for b0 in range(0, n_rows, THREADS):
        warps = [_warp(ptr, r0, n_rows) for r0 in range(b0, b0 + THREADS, 32)]
        hubs = [h for _, hw, _ in warps for h in hw]
        idle = [not busy for _, _, busy in warps]
        if not any(idle):
            idle = [True] * len(warps)
        rank = np.cumsum(idle) - 1
        ht = np.concatenate([np.full(32, -1) if not idle[q] else rank[q] * 32 + LANES
                             for q in range(len(warps))])
        out.append(([x[0] for x in warps], hubs, ht, 32 * sum(idle)))
    return out


def _hub_rounds(hb, he, ht, stride):
    """[rounds, 8, 256] positions of a hub's arcs by thread (-1: none), a
    round of 8 a thread, in order."""
    n_rounds = max(1, -(-(he - hb) // (LANE_ARCS * stride)))
    i = np.arange(n_rounds * LANE_ARCS).reshape(n_rounds, LANE_ARCS, 1)
    k = hb + np.maximum(ht, 0)[None, None] + i * stride
    return np.where((k < he) & (ht >= 0)[None, None], k, -1)


def _warp_then_block(per_thread, op, first):
    """Per-thread values [256] reduced by warp (xor tree), then over the
    warps in order from ``first``."""
    warp = _xor_reduce(per_thread.reshape(8, 32), 32, op)[:, 0]
    acc = first
    for v in warp:
        acc = F32(op(acc, v))
    return acc


def _step_arcs(idx, w, em, r, b):
    arc = idx.arc[r].numpy()
    W = w[b if w.shape[0] > 1 else 0]
    M = None if em is None else em[b if em.shape[0] > 1 else 0]

    def contrib(a, k):
        """c at positions k (-1: none: -inf) from source values a."""
        ids = arc[np.maximum(k, 0)]
        c = (a + W[ids]).astype(F32)
        if M is not None:
            c = (c + M[ids]).astype(F32)
        return np.where(k >= 0, c, -np.inf).astype(F32)

    return contrib


def _emulate_fwd(alpha, idx, w, em):
    """(new, m, z) [B, S] of the forward kernel's schedule."""
    B, S = alpha.shape
    out = np.full((B, S), NEG, F32)
    m_out, z_out = np.full((B, S), NEG, F32), np.zeros((B, S), F32)
    for b in range(B):
        r = b if idx.batched else 0
        ptr, src = idx.dptr[r].numpy(), idx.src[r].numpy()
        contrib = _step_arcs(idx, w, em, r, b)

        def c_at(k):
            u = src[np.maximum(k, 0)]
            a = np.where(u >= 0, alpha[b, np.maximum(u, 0)], F32(NEG)).astype(F32)
            return contrib(a, k)

        def emit(rows, m, z):
            out[b, rows] = np.where(z > 0, m + np.log(np.maximum(z, F32(1e-30))), NEG)
            m_out[b, rows], z_out[b, rows] = m, z

        for warps, hubs, ht, stride in _blocks(ptr, S):
            for passes in warps:
                for own, b0, e0, g, sub in passes:
                    k = b0[None] + sub[None] + np.arange(LANE_ARCS)[:, None] * g[None]
                    c = c_at(np.where(k < e0[None], k, -1))
                    m = np.maximum(_xor_reduce(c.max(axis=0), g, np.maximum), F32(NEG))
                    z = np.zeros(32, F32)
                    for j in range(LANE_ARCS):
                        z = (z + np.where(c[j] > DEAD, np.exp(c[j] - m), 0)).astype(F32)
                    z = _xor_reduce(z, g, np.add)
                    keep = (sub == 0) & (own >= 0)
                    emit(own[keep], m[keep], z[keep])
            for h in hubs:
                c = c_at(_hub_rounds(ptr[h], ptr[h + 1], ht, stride)).reshape(-1, THREADS)
                m = np.maximum(_warp_then_block(c.max(axis=0), np.maximum, F32(-np.inf)),
                               F32(NEG))
                z = np.zeros(THREADS, F32)
                for row in c:
                    z = (z + np.where(row > DEAD, np.exp(row - m), 0)).astype(F32)
                emit([h], m, _warp_then_block(z, np.add, F32(0.0)))
    return out, m_out, z_out


def _emulate_bwd(alpha, idx, w, em, m, z, g, A):
    """(dalpha [B, S], dcontrib [B, A]) of the backward kernel's schedule."""
    B, S = alpha.shape
    dalpha, dc = np.zeros((B, S), F32), np.full((B, A), np.nan, F32)
    for b in range(B):
        r = b if idx.batched else 0
        ptr, sarc, sdst = (getattr(idx, f)[r].numpy() for f in ("sptr", "sarc", "sdst"))
        contrib = _step_arcs(idx._replace(arc=idx.sarc), w, em, r, b)

        def lane_sums(j, a):
            """Each lane's sum of its arcs' cotangents at positions j [8, n]
            (-1: none), from 0 in order; writes them to dc."""
            d = sdst[np.maximum(j, 0)]
            live = (j >= 0) & (d >= 0)
            dd = np.maximum(d, 0)
            c = contrib(a, np.where(live, j, -1))
            zd = z[b, dd]
            v = np.where(live & (c > DEAD) & (zd > 0),
                         np.exp(c - m[b, dd]) / np.where(zd > 0, zd, 1) * g[b, dd], 0)
            v = v.astype(F32)
            dc[b, sarc[j[j >= 0]]] = v[j >= 0]
            s = np.zeros(v.shape[1:], F32)
            for row in v:
                s = (s + row).astype(F32)
            return s

        dc[b, sarc[ptr[S]:]] = 0.0
        for warps, hubs, ht, stride in _blocks(ptr, S):
            for passes in warps:
                for own, b0, e0, gw, sub in passes:
                    k = b0[None] + sub[None] + np.arange(LANE_ARCS)[:, None] * gw[None]
                    s = lane_sums(np.where(k < e0[None], k, -1), alpha[b, np.maximum(own, 0)])
                    s = _xor_reduce(s, gw, np.add)
                    keep = (sub == 0) & (own >= 0)
                    dalpha[b, own[keep]] = s[keep]
            for h in hubs:
                s = np.zeros(THREADS, F32)
                for rnd in _hub_rounds(ptr[h], ptr[h + 1], ht, stride):
                    s = (s + lane_sums(rnd, alpha[b, h])).astype(F32)
                dalpha[b, h] = _warp_then_block(s, np.add, F32(0.0))
    assert not np.isnan(dc).any()
    return dalpha, dc


EMU_TOL = dict(rtol=1e-5, atol=1e-5)


def _emu_case(layout, dead=False):
    import chip_smoke

    alpha, src, dst, w, em, g = chip_smoke.seglse_case(torch, "cpu", layout, b=2, s=600,
                                                       dead=dead)
    return alpha, src, dst, w, em, g, slp.arc_index(src, dst, alpha.shape[1])


def _emulated(alpha, idx, w, em, g, A):
    np_ = lambda x: None if x is None else x.numpy()  # noqa: E731
    out, m, z = _emulate_fwd(alpha.numpy(), idx, np_(w), np_(em))
    return (out,) + _emulate_bwd(alpha.numpy(), idx, np_(w), np_(em), m, z, g.numpy(), A)


@pytest.mark.parametrize("layout", ["sss", "bbb", "sbn", "bsb", "ssn", "bbn"])
def test_kernel_schedule_emulation_matches_plain(layout):
    """Hubs past one block's registers (4,500 and 400 in-arcs, 4,300 and
    700 out-arcs), rows of every group width, empty destinations, dead
    sources, endpoints outside [0, S): the emulated kernels against the
    plain versions, in float64."""
    alpha, src, dst, w, em, g, idx = _emu_case(layout)
    widths = {_width(n) for n in np.diff(idx.dptr[0].numpy())}
    assert widths == {0, 1, 2, 4, 8, 16, 32, -1}
    assert any(len(warp) > 1 for block in _blocks(idx.dptr[0].numpy(), alpha.shape[1])
               for warp in block[0])  # a warp of several passes
    assert (np.diff(idx.sptr[0].numpy()) > LANE_ARCS * THREADS).any()
    out, dalpha, dc = _emulated(alpha, idx, w, em, g, src.shape[1])
    em64 = 0.0 if em is None else em.double()
    p_out = slp.seg_lse_fwd_plain(alpha.double(), src, dst, w.double(), em64)
    p_da, p_dc = slp.seg_lse_bwd_plain(alpha.double(), src, dst, w.double(), em64, g.double())
    np.testing.assert_allclose(out, p_out.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dalpha, p_da.numpy(), **EMU_TOL)
    np.testing.assert_allclose(dc, p_dc.numpy(), **EMU_TOL)


def test_kernel_schedule_emulation_all_dead():
    alpha, src, dst, w, em, g, idx = _emu_case("bbb", dead=True)
    out, dalpha, dc = _emulated(alpha, idx, w, em, g, src.shape[1])
    assert (out == NEG).all()
    assert not dalpha.any() and not dc.any()


def test_kernel_schedule_emulation_matches_pallas():
    """On a live table with a hub of 3,200 in-arcs (every destination
    reached; the block's six warps without rows take it, in three rounds
    of 8 arcs a thread), the emulation against JAX's Pallas pair in
    interpret mode."""
    rng = np.random.RandomState(21)
    B, S, A = 2, 40, 3500
    src = rng.randint(0, S, (1, A)).astype(np.int32)
    dst = np.concatenate([np.arange(S), np.full(3200, 5), rng.randint(0, S, A - S - 3200)])
    dst = dst[None].astype(np.int32)
    alpha = rng.randn(B, S).astype(np.float32)
    w = (rng.randn(1, A) * 0.5).astype(np.float32)
    em = rng.randn(B, A).astype(np.float32)
    g = rng.rand(B, S).astype(np.float32)
    idx = slp.arc_index(torch.from_numpy(src), torch.from_numpy(dst), S)
    (_, hubs, ht, stride), = _blocks(idx.dptr[0].numpy(), S)
    assert hubs == [5] and stride == 6 * 32 and 3200 > LANE_ARCS * stride
    out, dalpha, dc = _emulated(torch.from_numpy(alpha), idx, torch.from_numpy(w),
                                torch.from_numpy(em), torch.from_numpy(g), A)
    j_out, vjp = jax.vjp(lambda a, w, e: jax_seglse.seg_lse(a, jnp.asarray(src),
                                                            jnp.asarray(dst), w, e),
                         *(jnp.asarray(x) for x in (alpha, w, em)))
    j_da, j_dw, j_dem = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(j_out), **VALUE_TOL)
    np.testing.assert_allclose(dalpha, np.asarray(j_da), **GRAD_TOL)
    np.testing.assert_allclose(dc, np.asarray(j_dem), **GRAD_TOL)
    np.testing.assert_allclose(dc.sum(0, keepdims=True), np.asarray(j_dw), **GRAD_TOL)


# ---------------------------------------------------------------------------
# The CUDA route, with plain stand-ins for the kernels
# ---------------------------------------------------------------------------


def _endpoints(idx):
    """(src, dst) [rows, A] in the arcs' own order, read back from the
    index (-1 where invalid)."""
    rows, A = idx.arc.shape
    k = torch.arange(A).expand(rows, A).contiguous()
    d = torch.searchsorted(idx.dptr[:, 1:].long().contiguous(), k, right=True)
    d = torch.where(d < idx.dptr.shape[1] - 1, d, -1)
    src = torch.full((rows, A), -1, dtype=torch.long).scatter_(1, idx.arc.long(), idx.src.long())
    return src, torch.full((rows, A), -1, dtype=torch.long).scatter_(1, idx.arc.long(), d)


def _stand_ins(monkeypatch, calls):
    """The CUDA route forced (``_build.on_cuda``) and the kernels' wrappers
    replaced by plain versions that read the endpoints from the index, w
    and em as given (the arcs' own order) and hand the forward's
    statistics to the backward, appending their names to ``calls``;
    ``take``/``untake`` refuse."""
    def fwd(alpha, w, em, idx, stats=False, staged=None):
        calls.append("fwd")
        src, dst = _endpoints(idx)
        em = 0.0 if em is None else em
        out = slp.seg_lse_fwd_plain(alpha, src, dst, w, em)
        _, _, _, m, z = slp._segments(alpha, src, dst, w, em)
        S = alpha.shape[1]
        return (out, m[:, :S].contiguous(), z[:, :S].contiguous()) if stats else out

    def bwd(alpha, w, em, idx, m, z, g, need_dcontrib=True):
        calls.append("bwd")
        src, dst = _endpoints(idx)
        da, dc = slp.seg_lse_bwd_plain(alpha, src, dst, w, 0.0 if em is None else em, g)
        return da, (dc if need_dcontrib else None)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route gathered into the sorted order")

    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(slp, "seg_lse_fwd_cuda", fwd)
    monkeypatch.setattr(slp, "seg_lse_bwd_cuda", bwd)
    monkeypatch.setattr(slp, "take", refuse)
    monkeypatch.setattr(slp, "untake", refuse)


@pytest.mark.parametrize("layout", ["sbs", "bsn"])
def test_cuda_route_is_one_launch_a_step_and_gathers_nothing(monkeypatch, layout):
    """The wrapper on the CUDA route (forced, plain stand-ins for the
    kernels): one launch forward, one backward, no take/untake, and the
    CPU route's values and gradients."""
    alpha, src, dst, w, em, g = _case(layout[:2] + ("s" if layout[2] == "n" else layout[2]),
                                      "jax")
    em = None if layout[2] == "n" else em

    def run():
        t = [torch.from_numpy(x).requires_grad_(True) for x in (alpha, w)]
        e = None if em is None else torch.from_numpy(em).requires_grad_(True)
        out = slp.seg_lse(t[0], torch.from_numpy(src), torch.from_numpy(dst), t[1], e)
        grads = torch.autograd.grad(out, t + ([] if e is None else [e]), torch.from_numpy(g))
        return [out.detach()] + list(grads)

    ref = run()
    calls = []
    _stand_ins(monkeypatch, calls)
    got = run()
    assert calls == ["fwd", "bwd"]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
