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
forward, and by source and by label for the backward.  A table that does
not fit in shared memory beside the state is read from global memory; a
backward whose float64 state does not fit either (S = 1,058 at closure
depth 4, the unpruned grapheme 4-gram's normaliser: 250 KB) keeps the
state in a global scratch slice per sample, which stays in L2.
"""

from typing import NamedTuple, Optional

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
    arcs)."""

    S: int
    C: int
    src: torch.Tensor
    dst: torch.Tensor
    label: torch.Tensor
    eps_src: torch.Tensor
    eps_dst: torch.Tensor
    main: Optional[ArcIndex] = None
    eps: Optional[ArcIndex] = None


def scan_plan(src, dst, label, eps_src, eps_dst, S, C):
    """The ``ScanPlan`` of a table's structure over C emission channels."""
    main = eps = None
    if _build.on_cuda(src):
        main = arc_index(src, dst, S, label, C)
        if eps_src.shape[-1]:
            eps = arc_index(eps_src, eps_dst, S)
    return ScanPlan(S, C, src, dst, label, eps_src, eps_dst, main, eps)


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
# CUDA kernels
# ---------------------------------------------------------------------------


def smem_bytes(S, A, E, C, depth, backward):
    """(state bytes, table bytes) of a block's shared memory, as laid out
    by the kernels of csrc/sparse_scan.cu; the tables are staged there
    when both fit."""
    D = depth
    if backward:
        # the chain's state in float64, the arcs' posteriors and em in float32
        state = 2 * S * (5 * D + 7) + A + E + C
        tables = 2 * (S + 1) + 5 * A + (C + 1) + (2 * (S + 1) + 3 * E if D else 0)
    else:
        state = 32 + 4 * S + C
        tables = (S + 1) + 3 * A + ((S + 1) + 2 * E if D else 0)
    return 4 * state, 4 * tables


def tables_in_smem(S, A, E, C, depth, backward):
    """Whether the kernel stages the tables in shared memory (they fit
    there beside its state)."""
    state, tables = smem_bytes(S, A, E, C, depth, backward)
    return state + tables <= _build.MAX_SMEM


def state_in_smem(S, A, E, C, depth, backward):
    """Whether the kernel's state fits in shared memory; the backward's
    otherwise lives in global scratch."""
    return smem_bytes(S, A, E, C, depth, backward)[0] <= _build.MAX_SMEM


def _launch_args(name, em, lens, plan, w, eps_w, depth):
    """Checked, sorted inputs shared by both launches."""
    B, T, C = em.shape
    idx, eidx = plan.main, plan.eps
    if idx is None:
        raise ValueError(f"{name}: the plan has no CUDA index (built on the CPU?)")
    _build.require_cuda(name, em, lens, idx.dptr, w)
    _build.require(f"{name} lengths", lens, (B,), torch.int32)
    if C != plan.C or idx.order.shape[0] not in (1, B) or T < 1:
        raise ValueError(f"{name}: em {tuple(em.shape)} does not fit the plan")
    A = idx.order.shape[1]
    depth = depth if eidx is not None else 0
    E = eidx.order.shape[1] if depth else 0
    w_s = take(w, idx.order)
    ew_s = take(eps_w, eidx.order) if depth else None
    flags = (int(idx.batched), int(w_s.shape[0] == B > 1),
             int(depth > 0 and eidx.batched), int(depth > 0 and ew_s.shape[0] == B > 1))
    return B, T, C, A, E, depth, w_s, ew_s, flags


def _ptr(x):
    return None if x is None else x.data_ptr()


def sparse_scan_fwd_cuda(em, alpha0, lens, plan, w, eps_w, depth):
    """Launch ``sparse_scan_fwd``: em [B, T, C], alpha0 [B, S] float32,
    lens [B] int32, the plan's tables and w [Ba, A], eps_w [Be, E] ->
    (traj [B, T + 1, S], shift [B, T + 1] float64)."""
    B, T, C, A, E, depth, w_s, ew_s, flags = _launch_args(
        "sparse_scan_fwd", em, lens, plan, w, eps_w, depth)
    S = plan.S
    _build.require("sparse_scan_fwd alpha0", alpha0, (B, S), torch.float32)
    if not state_in_smem(S, A, E, C, depth, False):
        raise ValueError(f"sparse_scan_fwd: the state of S={S} states does not fit "
                         "in shared memory")
    in_smem = tables_in_smem(S, A, E, C, depth, False)
    idx, eidx = plan.main, plan.eps if depth else None
    traj = torch.empty((B, T + 1, S), dtype=torch.float32, device=em.device)
    shift = torch.empty((B, T + 1), dtype=torch.float64, device=em.device)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(em.device):
        err = lib.sparse_scan_fwd(
            em.data_ptr(), alpha0.data_ptr(), lens.data_ptr(), idx.dptr.data_ptr(),
            idx.src.data_ptr(), idx.label.data_ptr(), w_s.data_ptr(),
            _ptr(eidx and eidx.dptr), _ptr(eidx and eidx.src), _ptr(ew_s),
            traj.data_ptr(), shift.data_ptr(), B, T, C, S, A, E, depth, *flags,
            int(in_smem), _build.stream_handle(em),
        )
    _build.check(lib, err, "sparse_scan_fwd")
    _build.LAUNCHES["sparse_scan_fwd"] += 1
    return traj, shift


def sparse_scan_bwd_cuda(em, traj, lens, plan, w, eps_w, depth, g_final):
    """Launch ``sparse_scan_bwd`` -> (dem [B, T, C], dw [B, A],
    deps [B, E], dalpha0 [B, S]), per sample, in the arcs' own order."""
    B, T, C, A, E, depth, w_s, ew_s, flags = _launch_args(
        "sparse_scan_bwd", em, lens, plan, w, eps_w, depth)
    S = plan.S
    _build.require_cuda("sparse_scan_bwd", traj, g_final)
    _build.require("sparse_scan_bwd traj", traj, (B, T + 1, S), torch.float32)
    _build.require("sparse_scan_bwd g_final", g_final, (B, S), torch.float32)
    in_smem = tables_in_smem(S, A, E, C, depth, True)
    idx, eidx = plan.main, plan.eps if depth else None
    dev = em.device
    scratch = None
    if not state_in_smem(S, A, E, C, depth, True):
        # one slice a sample, a whole number of doubles (csrc: scan_state_stride)
        words = smem_bytes(S, A, E, C, depth, True)[0] // 4
        scratch = torch.empty((B, words + words % 2), dtype=torch.float32, device=dev)
    dem = torch.empty_like(em)
    dw_s = torch.empty((B, A), dtype=torch.float64, device=dev)
    deps_s = torch.empty((B, E), dtype=torch.float64, device=dev) if depth else None
    dalpha0 = torch.empty((B, S), dtype=torch.float32, device=dev)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(dev):
        err = lib.sparse_scan_bwd(
            em.data_ptr(), traj.data_ptr(), lens.data_ptr(), g_final.data_ptr(),
            idx.dptr.data_ptr(), idx.src.data_ptr(), idx.label.data_ptr(),
            w_s.data_ptr(), idx.sptr.data_ptr(), idx.sorder.data_ptr(),
            idx.lptr.data_ptr(), idx.lorder.data_ptr(),
            _ptr(eidx and eidx.dptr), _ptr(eidx and eidx.src), _ptr(ew_s),
            _ptr(eidx and eidx.sptr), _ptr(eidx and eidx.sorder),
            dem.data_ptr(), dw_s.data_ptr(), _ptr(deps_s), dalpha0.data_ptr(),
            _ptr(scratch), B, T, C, S, A, E, depth, *flags, int(in_smem),
            _build.stream_handle(em),
        )
    _build.check(lib, err, "sparse_scan_bwd")
    _build.LAUNCHES["sparse_scan_bwd"] += 1
    if depth:
        deps = untake(deps_s.float(), eidx.order)
    else:
        deps = torch.zeros(B, plan.eps_src.shape[-1], dtype=torch.float32, device=dev)
    return dem, untake(dw_s.float(), idx.order), deps, dalpha0


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
