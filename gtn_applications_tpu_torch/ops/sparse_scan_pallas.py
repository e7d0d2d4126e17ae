"""The whole sparse-arc lattice scan as one launch, with its VJP.

Counterpart of ``sparse_scan`` and ``scan_scores`` in
``gtn_applications_tpu/ops/sparse_scan_pallas.py`` (Pallas kernels
``_fwd_kernel`` and ``_bwd_kernel``).  The module keeps the JAX file's
name; the kernels are CUDA C++ for Hopper (``csrc/sparse_scan.cu``).

Recursion over frames t = 0 .. T-1 (frames t >= len keep alpha):

    y[s]   = logsumexp over arcs a into s of (alpha[src[a]] + w[a]) + em[t, label[a]]
    cur_0  = acc_0 = y
    cur_d  = logsumexp over epsilon arcs e into s of cur_{d-1}[esrc[e]] + ew[e]
    acc_d  = logaddexp(acc_{d-1}, cur_d)            d = 1 .. eps_depth
    alpha  = acc_{eps_depth}

Every logsumexp shifts each destination by its own largest contribution
and weighs dead contributions (<= DEAD) exactly 0: the port computes what
the JAX package's plain ``forward_score`` computes.  After each live frame
the frame's largest alpha (0 if every state is dead) is subtracted and
added to the sample's running ``shift [B, T+1]``: the trajectory holds
alpha relative to it, so the numbers the posteriors compare stay small
(alpha grows to ~700 over 100 frames of raw logits, where one fp32 ulp,
6e-5, would set the posteriors' precision), and the shift, a float64 sum,
carries the rest to the score.  The shift does not enter the gradient:
``sparse_scan`` returns (final alpha less its shift, the shift).
(The TPU kernel shifts each row by its largest contribution over all
arcs, so a destination more than ~80 nats below it underflows there and
not here.)
The backward replays each frame's chain from the saved trajectory
``[B, T+1, S]`` and runs it in reverse, the exact posterior VJP, masked
where a contribution or its destination is dead; the CUDA kernel replays
in float64 (its inputs and outputs float32), which keeps the cotangents
of a few hundred frames within 1e-5 of exact entry by entry, where float32
intermediates would not.  Cotangents go to the
emissions ``em [B, T, C]`` (read by label inside the kernel, so no
``[B, T, A]`` arc-emission tensor is formed), the arc weights, the
epsilon weights and ``alpha0``; a shared weight's gradient is summed over
the batch.

Tables: ``src``, ``dst``, ``label``, ``w`` ``[Ba, A]`` and ``eps_src``,
``eps_dst``, ``eps_w`` ``[Be, E]``, each with its own leading dim in
{1, B}.  The TPU module's one-hot projection matrices and its VMEM
planner (``predict_vmem_bytes``, ``choose_tiles``) served the MXU and
Mosaic only; the kernels here walk index tables built once per table
(``seglse_pallas.arc_index``): arcs grouped by destination for the
forward, and by source and by label for the backward.  Each sample runs
on a thread-block cluster of k blocks (``choose_cluster``), on a schedule
built on the host once per table and cluster size (``build_schedule``):
each block owns a share of the states and labels, its rows go to lane
groups by in-degree, and hub rows are cut into chunks.  A block's tables
are staged in its shared memory when they fit, else read from global
memory; a backward whose float64 state of the block's own states does
not fit either keeps it in a global scratch slice per block, which stays
in L2 (the unpruned grapheme 4-gram's normaliser, S = 1,058 at closure
depth 4, at one block a sample: ~250 KB).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .seglse_pallas import (
    ArcIndex, arc_index, seg_lse_bwd_plain, seg_lse_fwd_plain, sum_to, take,
    untake,
)
from .semiring import DEAD, NEG, logaddexp, logsumexp


class ScanPlan(NamedTuple):
    """A table's structure: the arc fields as given (2-D) and, for CUDA
    tensors, their index tables (``None`` on the CPU or without epsilon
    arcs) and the kernels' schedules by cluster size (``plan_schedule``)."""

    S: int
    C: int
    src: torch.Tensor
    dst: torch.Tensor
    label: torch.Tensor
    eps_src: torch.Tensor
    eps_dst: torch.Tensor
    main: Optional[ArcIndex]
    eps: Optional[ArcIndex]
    schedules: dict


def scan_plan(src, dst, label, eps_src, eps_dst, S, C):
    """The ``ScanPlan`` of a table's structure over C emission channels
    (its schedules are built at the first launch that needs each)."""
    main = eps = None
    if _build.on_cuda(src):
        main = arc_index(src, dst, S, label, C)
        if eps_src.shape[-1]:
            eps = arc_index(eps_src, eps_dst, S)
    return ScanPlan(S, C, src, dst, label, eps_src, eps_dst, main, eps, {})


def _em_rows(em_t, label):
    """em_t [B, C] read at each arc's label [Ba, A] -> [B, A] (0 for a
    label outside [0, C))."""
    B, C = em_t.shape
    lab = label.long().expand(B, label.shape[-1])
    ok = (lab >= 0) & (lab < C)
    return torch.where(ok, em_t.gather(1, torch.where(ok, lab, 0)), 0.0), lab, ok


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _eps_chain(y, plan, eps_w, depth):
    """The frame's closure chain: (curs, accs), depth + 1 entries each."""
    curs, accs = [y], [y]
    zero = torch.zeros_like(eps_w)
    for _ in range(depth):
        cur = seg_lse_fwd_plain(curs[-1], plan.eps_src, plan.eps_dst, eps_w, zero)
        curs.append(cur)
        accs.append(logaddexp(accs[-1], cur))
    return curs, accs


def sparse_scan_fwd_plain(em, alpha0, lens, plan, w, eps_w, depth):
    """(traj [B, T + 1, S], shift [B, T + 1] float64): alpha relative to
    the running shift (entry 0 is alpha0, shift 0)."""
    T = em.shape[1]
    lens = lens.view(-1, 1)
    alpha = alpha0
    shift = torch.zeros_like(alpha0[:, :1], dtype=torch.float64)
    traj, shifts = [alpha], [shift]
    for t in range(T):
        em_a, _, _ = _em_rows(em[:, t], plan.label)
        y = seg_lse_fwd_plain(alpha, plan.src, plan.dst, w, em_a)
        _, accs = _eps_chain(y, plan, eps_w, depth)
        sh = torch.amax(accs[-1], dim=1, keepdim=True)
        sh = torch.where(sh > DEAD, sh, 0.0)
        live = t < lens
        alpha = torch.where(live, accs[-1] - sh, alpha)
        shift = torch.where(live, shift + sh.double(), shift)
        traj.append(alpha)
        shifts.append(shift)
    return torch.stack(traj, dim=1), torch.cat(shifts, dim=1)


def sparse_scan_bwd_plain(em, traj, lens, plan, w, eps_w, depth, g_final):
    """(dem [B, T, C], dw [B, A], deps [B, E], dalpha0 [B, S]) from the
    cotangent of the final alpha, per sample."""
    B, T, C = em.shape
    lens = lens.view(-1, 1)
    zero = torch.zeros_like(eps_w)
    g = g_final
    dem = torch.zeros_like(em)
    dw = torch.zeros(B, plan.src.shape[-1], dtype=em.dtype, device=em.device)
    deps = torch.zeros(B, plan.eps_src.shape[-1], dtype=em.dtype, device=em.device)
    for t in reversed(range(T)):
        live = t < lens
        a_in = traj[:, t]
        em_a, lab, ok = _em_rows(em[:, t], plan.label)
        y0 = seg_lse_fwd_plain(a_in, plan.src, plan.dst, w, em_a)
        curs, accs = _eps_chain(y0, plan, eps_w, depth)
        g_acc = torch.where(live, g, 0.0)
        g_cur = [torch.zeros_like(y0) for _ in range(depth + 1)]
        for d in range(depth, 0, -1):
            # logaddexp's posteriors, from its own shift (as autodiff forms them)
            a, c = accs[d - 1], curs[d]
            m = torch.clamp(torch.maximum(a, c), min=NEG)
            ea = torch.where(a > DEAD, torch.exp(a - m), 0.0)
            ec = torch.where(c > DEAD, torch.exp(c - m), 0.0)
            z = ea + ec
            gz = torch.where(z > 0.0, g_acc / torch.where(z > 0.0, z, 1.0), 0.0)
            g_cur[d] = g_cur[d] + gz * ec
            g_acc = gz * ea
            dprev, dce = seg_lse_bwd_plain(curs[d - 1], plan.eps_src, plan.eps_dst,
                                           eps_w, zero, g_cur[d])
            g_cur[d - 1] = g_cur[d - 1] + dprev
            deps = deps + dce
        dalpha_in, dc = seg_lse_bwd_plain(a_in, plan.src, plan.dst, w, em_a,
                                          g_acc + g_cur[0])
        dw = dw + dc
        dem[:, t] = torch.zeros(B, C, dtype=em.dtype, device=em.device).scatter_add(
            1, torch.where(ok, lab, 0), torch.where(ok, dc, 0.0))
        g = torch.where(live, dalpha_in, g)
    return dem, dw, deps, g


# ---------------------------------------------------------------------------
# The kernels' schedule
# ---------------------------------------------------------------------------

# A group of g lanes (g in WIDTHS) reduces one row (a destination, a
# source or a label) of at most g * LANE_ARCS arcs, each lane holding up
# to LANE_ARCS of them; a hub row of more than HUB_ARCS arcs is cut into
# chunks of HUB_ARCS, a warp each, whose maxima and then sums meet in
# shared memory.  Must match csrc/sparse_scan.cu.
LANE_ARCS = 8
WIDTHS = (1, 4, 8, 32)
HUB_ARCS = 32 * LANE_ARCS
CLUSTER_SIZES = (1, 2, 4, 8)
# a rank's lists of rows: by destination (main arcs, epsilon arcs), by
# source (main, epsilon) and by label
LISTS = ("dst", "eps_dst", "src", "eps_src", "label")
# a rank's part of the schedule starts with its ranges (RANGES, 16 words)
# and then 6 words a list: slot offset, slots, hub offset, hubs, chunks,
# task offset (offsets in words from the part's start)
RANGES = ("s0", "s1", "a0", "a1", "e0", "e1", "l0", "l1",
          "sj0", "sj1", "ej0", "ej1", "lj0", "lj1")
HEADER = 48


class Schedule(NamedTuple):
    """Work matched to in-degree, for clusters of ``k`` blocks a sample.

    Each block (rank) of a sample's cluster owns a contiguous range of
    states (cut by their in-degree over the main and epsilon arcs, so that
    each rank holds about a k-th of the arcs) and of labels (cut by arc
    count); it computes its states' values and, in the backward, the sums
    of its states' out-arcs and of its labels' arcs.  ``words [rows, k,
    stride]`` int32 holds each rank's part: its ranges, then per list
    (``LISTS``) its slots (width g, first task's word offset, task count:
    the 32 / g tasks one warp runs), its hubs (row, first chunk, chunks)
    and its tasks (row, begin, end, aux: -1, or a hub chunk's
    ``hub << 16 | chunk index``).  ``refs`` (by source, by epsilon source,
    by label: [rows, A], [rows, E], [rows, A]) code each arc of those
    orders as ``rank | offset << 3``, its owner and its place among the
    owner's arcs, so a sum reads another block's posteriors without
    atomics.  ``sizes``: the largest range of each kind over rows and
    ranks, the most hub chunks in one list, the words of a part, of its
    forward lists and of its list by destination alone (the decode's,
    ``segmax_pallas.seg_max_scan``).  ``device``: (words, refs...) on the
    table's device."""

    k: int
    words: np.ndarray
    refs: tuple
    sizes: dict
    device: Optional[tuple] = None


def _cut(counts, k):
    """Cut keys [rows, n] into k contiguous ranges of near-equal count:
    (the owner rank of each key, bounds [rows, k + 1]).  A rank's count is
    within the largest key's count of the total over k."""
    rows, n = counts.shape
    before = np.cumsum(counts, axis=1) - counts
    total = np.maximum(counts.sum(axis=1, keepdims=True), 1)
    rank = np.minimum(k - 1, before * k // total)
    bounds = np.empty((rows, k + 1), np.int64)
    for r in range(k + 1):
        bounds[:, r] = (rank < r).sum(axis=1)
    return rank, bounds


def _width(count):
    """The lane group of a row of ``count`` arcs (hubs: a warp a chunk)."""
    width = np.full(count.shape, 32, np.int64)
    for g in reversed(WIDTHS):
        width[count <= g * LANE_ARCS] = g
    return width


def _list_tasks(ptr, owner, lst):
    """A list's tasks, one per row (a chunk per HUB_ARCS arcs of a hub)."""
    rows, n = owner.shape
    beg0, end0 = ptr[:, :-1].ravel(), ptr[:, 1:].ravel()
    count = end0 - beg0
    chunks = np.maximum(1, -(-count // HUB_ARCS))
    item = np.repeat(np.arange(rows * n), chunks)
    chunk = np.arange(item.size) - np.repeat(np.cumsum(chunks) - chunks, chunks)
    beg = beg0[item] + chunk * HUB_ARCS
    hub = count[item] > HUB_ARCS
    width = _width(count[item])
    # slots of hub chunks first, then the widest groups
    cls = np.where(hub, 0, len(WIDTHS) - np.searchsorted(WIDTHS, width))
    return dict(row=item // max(n, 1), rank=owner.ravel()[item],
                lst=np.full(item.size, lst), cls=cls, key=item % max(n, 1), chunk=chunk,
                beg=beg, end=np.minimum(beg + HUB_ARCS, end0[item]), width=width,
                chunks=chunks[item], hub=hub)


def _code(order, bounds):
    """(rank | offset << 3) of each sorted arc position in ``order``."""
    rank = np.zeros(order.shape, np.int64)
    for r in range(1, bounds.shape[1] - 1):
        rank += order >= bounds[:, r:r + 1]
    return (rank | (order - np.take_along_axis(bounds, rank, 1)) << 3).astype(np.int32)


def _host(x, width=None):
    """An index table on the host (``None``: one empty row of ``width``)."""
    if x is None:
        return np.zeros((1, width), np.int64)
    return x.detach().cpu().numpy().astype(np.int64)


def build_schedule(main, eps, S, C, k):
    """The ``Schedule`` of the index tables ``main`` (with labels over C
    channels) and ``eps`` (None without epsilon arcs) for clusters of k
    blocks, on the host."""
    if k not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {k} is not one of {CLUSTER_SIZES}")
    dptr, sptr, sorder = _host(main.dptr), _host(main.sptr), _host(main.sorder)
    lptr, lorder = _host(main.lptr), _host(main.lorder)
    eptr = _host(eps and eps.dptr, S + 1)
    esptr = _host(eps and eps.sptr, S + 1)
    esorder = _host(eps and eps.sorder, 0)
    A, E = sorder.shape[1], esorder.shape[1]
    rows = max(dptr.shape[0], eptr.shape[0])
    dptr, sptr, sorder, lptr, lorder, eptr, esptr, esorder = (
        np.broadcast_to(x, (rows,) + x.shape[1:])
        for x in (dptr, sptr, sorder, lptr, lorder, eptr, esptr, esorder))
    owner, sb = _cut(np.diff(dptr, axis=1) + np.diff(eptr, axis=1), k)
    lowner, lb = _cut(np.diff(lptr, axis=1), k)
    at = lambda p, b: np.take_along_axis(p, b, 1)  # noqa: E731
    ab, eb = at(dptr, sb), at(eptr, sb)
    ab[:, k], eb[:, k] = A, E  # arcs without a valid destination: the last rank's
    lo, hi = slice(0, k), slice(1, k + 1)
    ranges = np.stack([sb[:, lo], sb[:, hi], ab[:, lo], ab[:, hi], eb[:, lo], eb[:, hi],
                       lb[:, lo], lb[:, hi], at(sptr, sb)[:, lo], at(sptr, sb)[:, hi],
                       at(esptr, sb)[:, lo], at(esptr, sb)[:, hi],
                       at(lptr, lb)[:, lo], at(lptr, lb)[:, hi]], axis=2)

    lists = [_list_tasks(p, o, i) for i, (p, o) in enumerate(
        ((dptr, owner), (eptr, owner), (sptr, owner), (esptr, owner), (lptr, lowner)))]
    t = {f: np.concatenate([x[f] for x in lists]) for f in lists[0]}
    # by (row, rank, list, class); each list's tasks already come by row,
    # key and chunk, and a stable sort keeps that order within a class
    nl = len(LISTS)
    order = np.argsort(((t["row"] * k + t["rank"]) * nl + t["lst"]) * 8 + t["cls"],
                       kind="stable")
    t = {f: v[order] for f, v in t.items()}
    n_groups = rows * k * nl
    grp = (t["row"] * k + t["rank"]) * nl + t["lst"]
    idx = np.arange(grp.size)
    nt = np.bincount(grp, minlength=n_groups)
    ti = idx - (np.cumsum(nt) - nt)[grp]  # task index within its list
    run = grp * 8 + t["cls"]
    run_len = np.bincount(run, minlength=n_groups * 8)
    p = idx - (np.cumsum(run_len) - run_len)[run]
    per_slot = 32 // t["width"]
    first = p % per_slot == 0
    s_grp = grp[first]
    ns = np.bincount(s_grp, minlength=n_groups)
    s_ord = np.arange(s_grp.size) - (np.cumsum(ns) - ns)[s_grp]
    head = t["hub"] & (t["chunk"] == 0)
    h_grp = grp[head]
    nh = np.bincount(h_grp, minlength=n_groups)
    hub_of = np.full(grp.size, -1, np.int64)
    hub_of[head] = np.arange(h_grp.size) - (np.cumsum(nh) - nh)[h_grp]
    chunks = t["hub"]
    aux = np.where(chunks, hub_of[idx - t["chunk"]] << 16 | ti, -1)
    nchunk = np.bincount(grp[chunks], minlength=n_groups)
    if nt.max(initial=0) >= 1 << 16:
        raise ValueError("sparse_scan: a list of more than 65,535 tasks")

    size = (3 * ns + 3 * nh + 4 * nt).reshape(rows * k, nl)
    off = HEADER + np.cumsum(size, axis=1) - size
    part = HEADER + size.sum(axis=1)
    stride = int(-(-part.max() // 4) * 4)
    slot_off = off.ravel()
    hub_off = slot_off + 3 * ns
    task_off = hub_off + 3 * nh
    words = np.zeros((rows * k, stride), np.int64)
    words[:, :len(RANGES)] = ranges.reshape(rows * k, len(RANGES))
    hdr = np.stack([slot_off, ns, hub_off, nh, nchunk, task_off], 1).reshape(rows * k, nl * 6)
    words[:, 16:16 + 6 * nl] = hdr
    flat = words.reshape(-1)
    base = (grp // nl) * stride

    def put(at_word, grp_sel, values):
        for j, v in enumerate(values):
            flat[(grp_sel // nl) * stride + at_word + j] = v

    put(slot_off[s_grp] + 3 * s_ord, s_grp,
        (t["width"][first], task_off[s_grp] + 4 * ti[first],
         np.minimum(per_slot[first], run_len[run[first]] - p[first])))
    put(hub_off[h_grp] + 3 * hub_of[head], h_grp,
        (t["key"][head], ti[head], t["chunks"][head]))
    for j, v in enumerate((t["key"], t["beg"], t["end"], aux)):
        flat[base + task_off[grp] + 4 * ti + j] = v

    refs = (_code(sorder, ab), _code(esorder, eb), _code(lorder, ab))
    r = ranges.reshape(rows * k, len(RANGES))
    span = lambda name: int((r[:, RANGES.index(name + "1")]  # noqa: E731
                             - r[:, RANGES.index(name + "0")]).max())
    sizes = dict(states=span("s"), arcs=span("a"), eps=span("e"), src_refs=span("sj"),
                 eps_refs=span("ej"), label_refs=span("lj"),
                 parts=int(nchunk.max()) if nchunk.size else 0, stride=stride,
                 fwd_words=int((HEADER + size[:, :2].sum(axis=1)).max()),
                 dst_words=int((HEADER + size[:, 0]).max()))
    return Schedule(k, words.reshape(rows, k, stride).astype(np.int32), refs, sizes)


def cluster_candidates(B, sms):
    """The cluster sizes k with B * k blocks no more than the card's
    ``sms`` multiprocessors, largest first (1 where none is)."""
    return [k for k in reversed(CLUSTER_SIZES) if B * k <= sms] or [1]


def plan_schedule(plan, k):
    """The plan's schedule for clusters of k blocks, built on the first
    launch that asks for it and kept on the plan (its tensors on the
    table's device); a size not in ``CLUSTER_SIZES`` raises."""
    sched = plan.schedules.get(k)
    if sched is None:
        sched = build_schedule(plan.main, plan.eps, plan.S, plan.C, k)
        dev = plan.main.dptr.device
        sched = sched._replace(device=tuple(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (sched.words,) + sched.refs))
        plan.schedules[k] = sched
    return sched


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def smem_words(sizes, S, C, depth, backward):
    """(shared, own, tables) words (4 bytes) of a block's shared memory,
    as laid out by the kernels of csrc/sparse_scan.cu: ``shared`` always
    lies there (the state vectors other blocks write into, and the
    posteriors they read); ``own`` (the backward's float64 state of the
    rank's own states and arcs) there or in global scratch; the staged
    tables and schedule there when all three fit.  The forward's state
    vectors and shifts are float64, its sums and emission rows float."""
    n, a, e, p = sizes["states"], sizes["arcs"], sizes["eps"], sizes["parts"]
    D = depth
    if not backward:
        return 64 + 8 * S + 2 * n + 2 * C + 3 * p, 0, 3 * a + 2 * e + sizes["fwd_words"]
    shared = 2 * (D * S + 2 * p) + 2 * S + 2 * a + 2 * e + 2 * C
    own = 2 * (n * (5 * D + 6) + a + e)
    tables = (3 * a + 2 * e + sizes["stride"] + sizes["src_refs"] + sizes["eps_refs"]
              + sizes["label_refs"])
    return shared, own, tables


def scan_route(sizes, S, C, depth, backward):
    """(own state in shared memory, tables in shared memory); raises where
    the shared part alone does not fit."""
    shared, own, tables = smem_words(sizes, S, C, depth, backward)
    limit = _build.MAX_SMEM // 4
    if shared > limit:
        raise ValueError(f"sparse_scan: the state of S={S} states does not fit in "
                         "shared memory")
    return shared + own <= limit, shared + own + tables <= limit


def smem_bytes(sizes, S, C, depth, backward):
    """The dynamic shared memory a block of the scan launches with."""
    shared, own, tables = smem_words(sizes, S, C, depth, backward)
    own_smem, in_smem = scan_route(sizes, S, C, depth, backward)
    return 4 * (shared + own * own_smem + tables * in_smem)


def _fit(backward, k, smem, device):
    """Clusters of k blocks of the forward (or backward) scan with ``smem``
    bytes of shared memory each that the card holds at once."""
    import ctypes

    out = ctypes.c_int(0)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(device):
        err = lib.sparse_scan_fit(ctypes.addressof(out), int(backward), k, smem, None)
    _build.check(lib, err, "sparse_scan_fit")
    return out.value


def max_active_clusters(plan, depth, backward, k, device):
    """How many clusters of k blocks of the forward (or backward) scan on
    this plan's tables the card holds at once (the launch raises at 0)."""
    sched = plan_schedule(plan, k)
    depth = depth if plan.eps is not None else 0
    return _fit(backward, k, smem_bytes(sched.sizes, plan.S, plan.C, depth, backward),
                device)


def choose_cluster(plan, B, depth, device):
    """The cluster size both scans launch with for a batch of B: the
    largest k with B k blocks on the card's multiprocessors whose B
    clusters the card holds at once, forward and backward (else the
    largest with B k blocks on the card: its clusters then run in
    waves).  Kept on the plan.  A size whose clusters do not fit even
    without shared memory (the backward's registers) builds no schedule."""
    key = ("cluster", B, depth)
    if key not in plan.schedules:
        sizes = cluster_candidates(
            B, torch.cuda.get_device_properties(device).multi_processor_count)
        choice = sizes[0]
        for k in sizes:
            if min(_fit(bwd, k, 0, device) for bwd in (False, True)) < B:
                continue
            if min(max_active_clusters(plan, depth, bwd, k, device)
                   for bwd in (False, True)) >= B:
                choice = k
                break
        plan.schedules[key] = choice
    return plan.schedules[key]


def _launch_args(name, em, lens, plan, w, eps_w, depth, cluster):
    """Checked, sorted inputs shared by both launches, and the schedule."""
    B, T, C = em.shape
    idx, eidx = plan.main, plan.eps
    if idx is None:
        raise ValueError(f"{name}: the plan has no CUDA index (built on the CPU?)")
    _build.require_cuda(name, em, lens, idx.dptr, w)
    _build.require(f"{name} lengths", lens, (B,), torch.int32)
    if C != plan.C or idx.order.shape[0] not in (1, B) or T < 1:
        raise ValueError(f"{name}: em {tuple(em.shape)} does not fit the plan")
    depth = depth if eidx is not None else 0
    k = choose_cluster(plan, B, depth, em.device) if cluster is None else cluster
    sched = plan_schedule(plan, k)
    A = idx.order.shape[1]
    E = eidx.order.shape[1] if depth else 0
    w_s = take(w, idx.order)
    ew_s = take(eps_w, eidx.order) if depth else None
    flags = (int(idx.batched), int(w_s.shape[0] == B > 1),
             int(depth > 0 and eidx.batched), int(depth > 0 and ew_s.shape[0] == B > 1),
             int(sched.words.shape[0] > 1))
    return B, T, C, A, E, depth, w_s, ew_s, flags, sched


def _ptr(x):
    return None if x is None else x.data_ptr()


def sparse_scan_fwd_cuda(em, alpha0, lens, plan, w, eps_w, depth, cluster=None):
    """Launch ``sparse_scan_fwd``: em [B, T, C], alpha0 [B, S] float32,
    lens [B] int32, the plan's tables and w [Ba, A], eps_w [Be, E] ->
    (traj [B, T + 1, S], shift [B, T + 1] float64).  ``cluster``: blocks a
    sample (1, 2, 4 or 8; default ``choose_cluster``)."""
    B, T, C, A, E, depth, w_s, ew_s, flags, sched = _launch_args(
        "sparse_scan_fwd", em, lens, plan, w, eps_w, depth, cluster)
    S = plan.S
    _build.require("sparse_scan_fwd alpha0", alpha0, (B, S), torch.float32)
    _, in_smem = scan_route(sched.sizes, S, C, depth, False)
    idx, eidx = plan.main, plan.eps if depth else None
    z = sched.sizes
    traj = torch.empty((B, T + 1, S), dtype=torch.float32, device=em.device)
    shift = torch.empty((B, T + 1), dtype=torch.float64, device=em.device)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(em.device):
        err = lib.sparse_scan_fwd(
            em.data_ptr(), alpha0.data_ptr(), lens.data_ptr(), idx.src.data_ptr(),
            idx.label.data_ptr(), w_s.data_ptr(), _ptr(eidx and eidx.src), _ptr(ew_s),
            sched.device[0].data_ptr(), traj.data_ptr(), shift.data_ptr(),
            B, T, C, S, A, E, depth, *flags, sched.k, z["stride"], z["fwd_words"],
            z["states"], z["arcs"], z["eps"], z["parts"], int(in_smem),
            _build.stream_handle(em),
        )
    _build.check(lib, err, f"sparse_scan_fwd (cluster of {sched.k})")
    _build.LAUNCHES["sparse_scan_fwd"] += 1
    return traj, shift


def sparse_scan_bwd_cuda(em, traj, lens, plan, w, eps_w, depth, g_final, cluster=None):
    """Launch ``sparse_scan_bwd`` -> (dem [B, T, C], dw [B, A],
    deps [B, E], dalpha0 [B, S]), per sample, in the arcs' own order;
    ``cluster`` as for ``sparse_scan_fwd_cuda``."""
    B, T, C, A, E, depth, w_s, ew_s, flags, sched = _launch_args(
        "sparse_scan_bwd", em, lens, plan, w, eps_w, depth, cluster)
    S = plan.S
    _build.require_cuda("sparse_scan_bwd", traj, g_final)
    _build.require("sparse_scan_bwd traj", traj, (B, T + 1, S), torch.float32)
    _build.require("sparse_scan_bwd g_final", g_final, (B, S), torch.float32)
    own_smem, in_smem = scan_route(sched.sizes, S, C, depth, True)
    idx, eidx = plan.main, plan.eps if depth else None
    dev = em.device
    z = sched.sizes
    scratch = None
    if not own_smem:
        # one slice a block, a whole number of doubles
        words = smem_words(z, S, C, depth, True)[1]
        scratch = torch.empty((B * sched.k, words), dtype=torch.float32, device=dev)
    dem = torch.empty_like(em)
    dw_s = torch.empty((B, A), dtype=torch.float64, device=dev)
    deps_s = torch.empty((B, E), dtype=torch.float64, device=dev) if depth else None
    dalpha0 = torch.empty((B, S), dtype=torch.float32, device=dev)
    words, sref, esref, lref = sched.device
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(dev):
        err = lib.sparse_scan_bwd(
            em.data_ptr(), traj.data_ptr(), lens.data_ptr(), g_final.data_ptr(),
            idx.src.data_ptr(), idx.label.data_ptr(), w_s.data_ptr(),
            _ptr(eidx and eidx.src), _ptr(ew_s), words.data_ptr(), sref.data_ptr(),
            esref.data_ptr(), lref.data_ptr(), dem.data_ptr(), dw_s.data_ptr(),
            _ptr(deps_s), dalpha0.data_ptr(), _ptr(scratch),
            B, T, C, S, A, E, depth, *flags, sched.k, z["stride"], z["states"],
            z["arcs"], z["eps"], z["parts"], z["src_refs"], z["eps_refs"],
            z["label_refs"], int(own_smem), int(in_smem), _build.stream_handle(em),
        )
    _build.check(lib, err, f"sparse_scan_bwd (cluster of {sched.k})")
    _build.LAUNCHES["sparse_scan_bwd"] += 1
    if depth:
        deps = untake(deps_s.float(), eidx.order)
    else:
        deps = torch.zeros(B, plan.eps_src.shape[-1], dtype=torch.float32, device=dev)
    return dem, untake(dw_s.float(), idx.order), deps, dalpha0


def chain_probe(B, k, phases, device):
    """Launch ``sparse_scan_probe``: B clusters of k blocks run ``phases``
    phases of the scans' structure without arcs (one dependent load from
    the next block's shared memory and one cluster barrier a phase).  For
    timing only; no plain version, no count."""
    out = torch.empty(B * k, dtype=torch.float32, device=device)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(device):
        err = lib.sparse_scan_probe(out.data_ptr(), B, k, phases,
                                    _build.stream_handle(out))
    _build.check(lib, err, "sparse_scan_probe")
    return out


class _SparseScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, alpha0, w, eps_w, lens, plan, depth):
        em = em.to(torch.float32).contiguous()
        alpha0 = alpha0.to(torch.float32).contiguous()
        w = w.to(torch.float32)
        eps_w = eps_w.to(torch.float32)
        lens = lens.to(device=em.device, dtype=torch.int32).contiguous()
        args = (em, alpha0, lens, plan, w, eps_w, depth)
        if _build.on_cuda(em):
            traj, shift = sparse_scan_fwd_cuda(*args)
        else:
            traj, shift = sparse_scan_fwd_plain(*args)
        ctx.save_for_backward(em, traj, lens, w, eps_w)
        ctx.plan, ctx.depth = plan, depth
        shift_t = shift[:, -1].clone()
        ctx.mark_non_differentiable(shift_t)
        return traj[:, -1].clone(), shift_t

    @staticmethod
    def backward(ctx, g_final, _):
        em, traj, lens, w, eps_w = ctx.saved_tensors
        args = (em, traj, lens, ctx.plan, w, eps_w, ctx.depth,
                g_final.to(torch.float32).contiguous())
        if _build.on_cuda(em):
            dem, dw, deps, dalpha0 = sparse_scan_bwd_cuda(*args)
        else:
            dem, dw, deps, dalpha0 = sparse_scan_bwd_plain(*args)
        return (dem, dalpha0, sum_to(dw, w.shape[0]), sum_to(deps, eps_w.shape[0]),
                None, None, None)


def sparse_scan(em, alpha0, w, eps_w, lens, plan, depth):
    """(final alpha less its shift [B, S], the shift [B]) of the whole scan
    (see the module docstring); JAX's returns the final alpha itself.
    Differentiable in em [B, T, C], alpha0 [B, S], w [Ba, A] and
    eps_w [Be, E]; ``plan`` is ``scan_plan`` of the table's structure."""
    return _SparseScan.apply(em, alpha0, w, eps_w, lens, plan, depth)


def scan_scores(em, table_fields, alpha0, accept, input_lengths, eps_depth):
    """Per-sample forward scores [B] of the whole scan.

    Args:
      em: [B, T, C] emissions (read by arc label in the scan; JAX's version
        takes the gathered [B, T, A] arc emissions instead).
      table_fields: (src, dst, label, weight, eps_src, eps_dst, eps_weight),
        each [Ba, ·] with Ba in {1, B}.
      alpha0: [B, S] start potentials after the initial epsilon closure.
      accept: [Ba, S] accepting potentials.
      input_lengths: [B] int.
      eps_depth: the closure's depth.
    """
    src, dst, label, weight, eps_src, eps_dst, eps_w = table_fields
    S = alpha0.shape[-1]
    if eps_src.shape[-1] == 0:
        eps_depth = 0
    plan = scan_plan(src, dst, label, eps_src, eps_dst, S, em.shape[-1])
    final, shift = sparse_scan(em, alpha0, weight, eps_w, input_lengths, plan,
                               eps_depth)
    return (logsumexp(final + accept, dim=-1).double() + shift).to(final.dtype)
