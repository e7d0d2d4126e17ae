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
from gtn_applications_tpu_torch.ops import sparse
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


@pytest.mark.parametrize("broken", [False, True])
def test_smoke_sparse_check_holds_kernels(monkeypatch, broken):
    """``chip_smoke.hold_sparse_kernels`` with the CUDA wrappers replaced by
    plain versions that read the arc index as the kernels do (the
    endpoints from the index, w and em in the arcs' own order, the
    forward's statistics handed to the backward): it passes, and it
    fails when one emission cotangent is off by 1e-4 of its size."""
    import chip_smoke
    from tests.test_torch_seglse import _stand_ins

    def scan_fwd(*args, cluster):
        assert cluster in ssp.CLUSTER_SIZES
        return ssp.sparse_scan_fwd_plain(*args)

    def scan_bwd(*args, cluster):
        dem, dw, deps, dalpha0 = ssp.sparse_scan_bwd_plain(*args)
        if broken:
            i = int(dem.abs().argmax())
            dem.view(-1)[i] *= 1 + 1e-4
        return dem, dw, deps, dalpha0

    _stand_ins(monkeypatch, [])
    monkeypatch.setattr(ssp, "sparse_scan_fwd_cuda", scan_fwd)
    monkeypatch.setattr(ssp, "sparse_scan_bwd_cuda", scan_bwd)
    monkeypatch.setattr(ssp, "choose_cluster", lambda plan, b, depth, dev: 2)
    monkeypatch.setattr(ssp, "max_active_clusters", lambda *a: 1)
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


# ---------------------------------------------------------------------------
# The CUDA kernels' schedule (work matched to in-degree, a cluster a sample)
# ---------------------------------------------------------------------------

HUB_B, HUB_S, HUB_A, HUB_E, HUB_C = 3, 40, 900, 320, 6


def _hub_tables(layout):
    """``_tables`` with hubs: 300 arcs into state 0 and 280 out of state 3
    (a source hub), 300 arcs of label 0, and 270 epsilon arcs into state
    5; per sample, the hubs move."""
    t = _tables(layout, HUB_B, HUB_S, HUB_A, HUB_E, HUB_C, seed=21)
    for f, lo, hi, v in (("dst", 100, 400, 0), ("src", 400, 680, 3), ("label", 0, 300, 0),
                         ("eps_dst", 0, 270, 5)):
        x = t[f]
        if x.ndim == 1:
            x[lo:hi] = v
        else:
            for b in range(x.shape[0]):
                x[b, lo + 5 * b:hi + 5 * b] = v + b
    return t


def _index(t):
    as2d = lambda x: torch.from_numpy(x[None] if x.ndim == 1 else x)  # noqa: E731
    main = slp.arc_index(as2d(t["src"]), as2d(t["dst"]), HUB_S, as2d(t["label"]), HUB_C)
    eps = slp.arc_index(as2d(t["eps_src"]), as2d(t["eps_dst"]), HUB_S)
    return main, eps


def _part(words):
    """A rank's part of the schedule: its ranges and, per list, its tasks
    by slot (width, [(row, begin, end, aux)]) and its hubs."""
    ranges = dict(zip(ssp.RANGES, (int(x) for x in words)))
    lists = []
    for lst in range(len(ssp.LISTS)):
        slot_off, ns, hub_off, nh, nchunk, _ = (int(x) for x in words[16 + 6 * lst:][:6])
        slots = []
        for q in range(ns):
            g, toff, cnt = (int(x) for x in words[slot_off + 3 * q:][:3])
            slots.append((g, [tuple(int(x) for x in words[toff + 4 * i:][:4])
                              for i in range(cnt)]))
        hubs = [tuple(int(x) for x in words[hub_off + 3 * h:][:3]) for h in range(nh)]
        assert nchunk == sum(h[2] for h in hubs)
        lists.append((slots, hubs))
    return ranges, lists


def _lanes(g, beg, end):
    """Each lane's arcs of a group of g lanes: beg + sub + j g."""
    arcs = [list(range(beg + sub, end, g)) for sub in range(g)]
    assert all(len(a) <= ssp.LANE_ARCS for a in arcs)
    return arcs


def _butterfly(vals, op):
    """A segmented xor-shuffle reduction over one group's lanes."""
    vals, off = list(vals), len(vals) // 2
    while off:
        vals = [op(vals[i], vals[i ^ off]) for i in range(len(vals))]
        off //= 2
    return vals[0]


def _emulate_lse(lst, value):
    """One lse phase of a rank as the kernel runs it, in float64: per task
    a max pass and a sum pass over its lane group; hub chunks' maxima
    merged first, then their sums, in order.  {row: (m, z)}."""
    slots, hubs = lst
    out, part_m, part_z, chunks = {}, {}, {}, []
    dead = lambda c: c <= -1e28  # noqa: E731
    for g, tasks in slots:
        for key, beg, end, aux in tasks:
            cs = [[value(k) for k in arcs] for arcs in _lanes(g, beg, end)]
            m = max(_butterfly([max(c, default=-np.inf) for c in cs], max), NEG)
            if aux >= 0:
                part_m[aux & 0xFFFF] = m
                chunks.append((cs, aux))
                continue
            z = _butterfly([sum(np.exp(x - m) for x in c if not dead(x)) for c in cs],
                           lambda a, b: a + b)
            out[key] = (m, z)
    for cs, aux in chunks:
        _, pb, n = hubs[aux >> 16]
        m = max(max(part_m[p] for p in range(pb, pb + n)), NEG)
        part_z[aux & 0xFFFF] = _butterfly(
            [sum(np.exp(x - m) for x in c if not dead(x)) for c in cs], lambda a, b: a + b)
    for key, pb, n in hubs:
        m = max(max(part_m[p] for p in range(pb, pb + n)), NEG)
        out[key] = (m, sum(part_z[p] for p in range(pb, pb + n)))
    return out


def _emulate_sum(lst, value):
    """One sum phase of a rank (by source or by label): {row: sum}."""
    slots, hubs = lst
    out, part = {}, {}
    for g, tasks in slots:
        for key, beg, end, aux in tasks:
            s = _butterfly([sum(value(j) for j in arcs) for arcs in _lanes(g, beg, end)],
                           lambda a, b: a + b)
            if aux >= 0:
                part[aux & 0xFFFF] = s
            else:
                out[key] = s
    for key, pb, n in hubs:
        out[key] = sum(part[p] for p in range(pb, pb + n))
    return out


LAYOUTS = ["shared", "per_sample", "union"]


@pytest.mark.parametrize("k", ssp.CLUSTER_SIZES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_schedule_partitions_the_tables(layout, k):
    """Every row of every list is in exactly one (rank, group); the tasks'
    ranges cover each list's pointer range once; each rank holds its
    share of the arcs within one hub; the (rank, offset) codes by source,
    epsilon source and label invert the partition."""
    main, eps = _index(_hub_tables(layout))
    sched = ssp.build_schedule(main, eps, HUB_S, HUB_C, k)
    rows = sched.words.shape[0]
    assert rows == (1 if layout == "shared" else HUB_B)
    n = lambda x: x.numpy().astype(np.int64)  # noqa: E731
    pick = lambda x, r: x[r if x.shape[0] > 1 else 0]  # noqa: E731
    hubs_seen = 0
    for r in range(rows):
        dptr, eptr = n(pick(main.dptr, r)), n(pick(eps.dptr, r))
        ptrs = [dptr, eptr, n(pick(main.sptr, r)), n(pick(eps.sptr, r)),
                n(pick(main.lptr, r))]
        cost = np.diff(dptr) + np.diff(eptr)
        parts = [_part(sched.words[r, q]) for q in range(k)]
        for lst, ptr in enumerate(ptrs):
            keys, spans = [], []
            for q, (ranges, lists) in enumerate(parts):
                lo, hi = (ranges["l0"], ranges["l1"]) if lst == 4 else (ranges["s0"],
                                                                        ranges["s1"])
                slots, hubs = lists[lst]
                hubs_seen += len(hubs)
                for key, _, _ in hubs:
                    keys.append(key)
                for g, tasks in slots:
                    assert g in ssp.WIDTHS and len(tasks) <= 32 // g
                    for key, beg, end, aux in tasks:
                        assert lo <= key < hi, (lst, q, key)
                        spans.append((beg, end))
                        if aux < 0:
                            keys.append(key)
                            assert (beg, end) == (ptr[key], ptr[key + 1])
                            assert end - beg <= g * ssp.LANE_ARCS
                        else:
                            assert g == 32 and hubs[aux >> 16][0] == key
            assert sorted(keys) == list(range(len(ptr) - 1)), lst
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == ptr[-1], lst
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), lst
        bounds = [p[0]["s0"] for p in parts] + [parts[-1][0]["s1"]]
        assert bounds[0] == 0 and bounds[-1] == HUB_S
        per_rank = np.array([cost[lo:hi].sum() for lo, hi in zip(bounds, bounds[1:])])
        assert abs(per_rank - cost.sum() / k).max() <= cost.max() + 1e-9
        codes = zip(sched.refs, ("a", "e", "a"), (pick(main.sorder, r), pick(eps.sorder, r),
                                                  pick(main.lorder, r)))
        for ref, kind, order in codes:
            code = pick(ref, r).astype(np.int64)
            rank, off = code & 7, code >> 3
            a0 = np.array([p[0][kind + "0"] for p in parts])
            a1 = np.array([p[0][kind + "1"] for p in parts])
            assert (a0[rank] + off == n(order)).all()
            assert (a0[rank] + off < a1[rank]).all()
    assert hubs_seen > 0


def _emulated_step(sched, idx, alpha, w, em, g):
    """seg_lse and its VJP over ``idx``'s arcs as the kernels' phases run
    them (by destination, then by source with the codes into each rank's
    posteriors, then by label): (new, dalpha, dcontrib in sorted order,
    sums by label)."""
    B, S = alpha.shape
    rows, k = sched.words.shape[:2]
    src = idx.src.numpy()
    new = np.full((B, S), np.nan)
    dalpha = np.full((B, S), np.nan)
    dc_all = np.zeros((B, src.shape[1]))
    by_label = {}
    for b in range(B):
        parts = [_part(sched.words[b if rows > 1 else 0, q]) for q in range(k)]
        s_b = src[b if src.shape[0] > 1 else 0]
        value = lambda j: ((alpha[b, s_b[j]] if s_b[j] >= 0 else NEG)  # noqa: E731
                           + w[b, j]) + em[b, j]
        dcs = []
        for ranges, lists in parts:
            segs = _emulate_lse(lists[0], value)
            for key, (m, z) in segs.items():
                new[b, key] = m + np.log(max(z, 1e-30)) if z > 0 else NEG
            dc = np.zeros(ranges["a1"] - ranges["a0"])
            for _, tasks in lists[0][0]:
                for key, beg, end, _ in tasks:
                    m, z = segs[key]
                    for j in range(beg, end):
                        c = value(j)
                        dc[j - ranges["a0"]] = (np.exp(c - m) / z * g[b, key]
                                                if c > -1e28 and z > 0 else 0.0)
            dcs.append(dc)
        dc_all[b] = np.concatenate(dcs)
        row = b if rows > 1 else 0
        read = lambda ref: lambda j: dcs[ref[row, j] & 7][ref[row, j] >> 3]  # noqa: E731
        for _, lists in parts:
            for key, v in _emulate_sum(lists[2], read(sched.refs[0])).items():
                dalpha[b, key] = v
            for key, v in _emulate_sum(lists[4], read(sched.refs[2])).items():
                by_label[b, key] = v
    return new, dalpha, dc_all, by_label


@pytest.mark.parametrize("k", ssp.CLUSTER_SIZES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_schedule_emulation_matches_seg_lse(layout, k):
    """One step run as the kernels' phases run it (lane groups, segmented
    two-pass reductions, hub chunks merged max-first, sums by source and
    by label through the (rank, offset) codes), in float64, against
    ``seg_lse_fwd_plain`` / ``seg_lse_bwd_plain`` within 1e-12."""
    t = _hub_tables(layout)
    main, _ = _index(t)
    sched = ssp.build_schedule(main, None, HUB_S, HUB_C, k)
    rng = np.random.RandomState(30 + k)
    B = HUB_B
    alpha = rng.randn(B, HUB_S) * 3
    alpha[:, ::7] = NEG  # dead states
    as2d = lambda x: np.broadcast_to(x[None] if x.ndim == 1 else x, (B, HUB_A))  # noqa: E731
    w = as2d(t["weight"]).astype(np.float64)
    em = rng.randn(B, HUB_A)
    g = rng.rand(B, HUB_S)
    order = main.order.expand(B, HUB_A).numpy()
    sorted_ = lambda x: np.take_along_axis(x, order, 1)  # noqa: E731
    new, dalpha, dc_s, by_label = _emulated_step(sched, main, alpha, sorted_(w),
                                                 sorted_(em), g)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    src, dst = T(as2d(t["src"]).astype(np.int64)), T(as2d(t["dst"]).astype(np.int64))
    ref = slp.seg_lse_fwd_plain(T(alpha), src, dst, T(w), T(em)).numpy()
    live = ref > NEG / 2
    assert np.array_equal(new > NEG / 2, live)
    np.testing.assert_allclose(new[live], ref[live], rtol=0, atol=1e-12)
    da, dc = slp.seg_lse_bwd_plain(T(alpha), src, dst, T(w), T(em), T(g))
    np.testing.assert_allclose(dalpha, da.numpy(), rtol=0, atol=1e-12)
    dc_k = np.zeros_like(dc_s)
    np.put_along_axis(dc_k, order, dc_s, 1)
    np.testing.assert_allclose(dc_k, dc.numpy(), rtol=0, atol=1e-12)
    label = as2d(t["label"]).astype(np.int64)
    for b in range(B):
        want = np.bincount(label[b], weights=dc.numpy()[b], minlength=HUB_C)
        got = np.array([by_label[b, c] for c in range(HUB_C)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", ssp.CLUSTER_SIZES)
def test_schedule_emulation_matches_seg_lse_on_epsilon_arcs(k):
    """The epsilon lists (a hub of in-degree 270): one closure round as
    the kernels run it, against ``seg_lse_fwd_plain``, and its sums by
    source against ``seg_lse_bwd_plain``, within 1e-12."""
    t = _hub_tables("per_sample")
    main, eps = _index(t)
    sched = ssp.build_schedule(main, eps, HUB_S, HUB_C, k)
    rng = np.random.RandomState(40 + k)
    B, E = HUB_B, HUB_E
    cur = rng.randn(B, HUB_S)
    ew = t["eps_weight"].astype(np.float64)
    g = rng.rand(B, HUB_S)
    order = eps.order.numpy()
    esrc = eps.src.numpy()
    new = np.full((B, HUB_S), np.nan)
    dprev = np.full((B, HUB_S), np.nan)
    for b in range(B):
        parts = [_part(sched.words[b, q]) for q in range(k)]
        ew_s = ew[b][order[b]]
        value = lambda j: (cur[b, esrc[b, j]] if esrc[b, j] >= 0 else NEG) + ew_s[j]  # noqa: E731,B023
        dcs = []
        for ranges, lists in parts:
            segs = _emulate_lse(lists[1], value)
            dc = np.zeros(ranges["e1"] - ranges["e0"])
            for key, (m, z) in segs.items():
                new[b, key] = m + np.log(max(z, 1e-30)) if z > 0 else NEG
            for _, tasks in lists[1][0]:
                for key, beg, end, _ in tasks:
                    m, z = segs[key]
                    for j in range(beg, end):
                        dc[j - ranges["e0"]] = np.exp(value(j) - m) / z * g[b, key]
            dcs.append(dc)
        ref = sched.refs[1]
        for _, lists in parts:
            for key, v in _emulate_sum(
                    lists[3], lambda j: dcs[ref[b, j] & 7][ref[b, j] >> 3]).items():  # noqa: B023
                dprev[b, key] = v
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    es, ed = T(t["eps_src"].astype(np.int64)), T(t["eps_dst"].astype(np.int64))
    zero = torch.zeros(B, E, dtype=torch.float64)
    ref_new = slp.seg_lse_fwd_plain(T(cur), es, ed, T(ew), zero).numpy()
    np.testing.assert_allclose(new, ref_new, rtol=0, atol=1e-12)
    ref_d, _ = slp.seg_lse_bwd_plain(T(cur), es, ed, T(ew), zero, T(g))
    np.testing.assert_allclose(dprev, ref_d.numpy(), rtol=0, atol=1e-12)


def test_cluster_size_fills_the_card():
    """The candidate sizes, largest first, are those of 1, 2, 4, 8 with
    B k blocks on the card's multiprocessors; a bad size is refused."""
    assert [ssp.cluster_candidates(b, 132)[0] for b in (1, 5, 16, 17, 33, 34, 66, 67, 200)
            ] == [8, 8, 8, 4, 4, 2, 2, 1, 1]
    assert ssp.cluster_candidates(32, 132) == [4, 2, 1]
    main, eps = _index(_hub_tables("shared"))
    with pytest.raises(ValueError, match="cluster size 3"):
        ssp.build_schedule(main, eps, HUB_S, HUB_C, 3)
