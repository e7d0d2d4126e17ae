"""Whole-scan dense-adjacency lattice recursion with a hand-written VJP.

Counterpart of ``dense_scan`` in ``gtn_applications_tpu/ops/dense_scan_pallas.py``
(Pallas kernels ``_fwd_kernel`` / ``_bwd_kernel``).  The module keeps the
JAX file's name; the kernels are CUDA C++ for Hopper (``csrc/dense_scan.cu``).
The transition-factored pair of that file (``factored_scan``) waits for
ROADMAP queue A item 8.

Recursion (frame 0 always applied; frames t >= len keep alpha):

    t = 0 : e = exp(min(start, 0)) * (start > NEG/2)
    t > 0 : sh = max(max(alpha), NEG) (no gradient), e = exp(alpha - sh)
    z[u]  = sum_s adj_exp[u, s] * e[s]
    new   = em_state[t] + sh + log(max(z, 1e-37))  where (z > 0) & has_lab
            else NEG

``dense_scan`` returns the final alpha; its backward replays the
trajectory in reverse, recomputing ``z``, and gives cotangents to
``em_state`` and (only when it needs one) ``adj_exp``; ``start``,
``has_lab`` and ``lengths`` are prepared data and get none.  The layout is
``[B, T, S]`` with S unpadded: the TPU's ``[T, B, S]`` transpose and its
128-lane padding existed only for its tiling.
"""

import torch

from . import _build
from .semiring import NEG

# as the JAX module (and ops/factored.py): a normal fp32 number, so log z
# bottoms out at -85, not at the CTC kernels' -69
_FLOOR = 1e-37


def _start_e(start):
    return torch.exp(torch.clamp(start, max=0.0)) * (start > NEG / 2)


def _bmv(adj, e):
    """z[b, u] = sum_s adj[b, u, s] * e[b, s]."""
    return torch.bmm(adj, e[:, :, None])[:, :, 0]


def _bmv_t(adj, g):
    """w[b, s] = sum_u adj[b, u, s] * g[b, u]."""
    return torch.bmm(g[:, None, :], adj)[:, 0, :]


def dense_scan_fwd_plain(em_state, adj_exp, start, has_lab, lengths):
    """The alpha trajectory [B, T, S], frame by frame."""
    B, T, _ = em_state.shape
    lab = has_lab > 0.0
    lens = lengths.view(B, 1)
    z = _bmv(adj_exp, _start_e(start))
    alpha = torch.where((z > 0.0) & lab,
                        em_state[:, 0] + torch.log(torch.clamp(z, min=_FLOOR)), NEG)
    traj = [alpha]
    for t in range(1, T):
        sh = torch.clamp(torch.amax(alpha, dim=1, keepdim=True), min=NEG)
        z = _bmv(adj_exp, torch.exp(alpha - sh))
        new = torch.where((z > 0.0) & lab,
                          em_state[:, t] + sh + torch.log(torch.clamp(z, min=_FLOOR)),
                          NEG)
        alpha = torch.where(t < lens, new, alpha)
        traj.append(alpha)
    return torch.stack(traj, dim=1)


def dense_scan_bwd_plain(traj, adj_exp, start, has_lab, lengths, g_final,
                         need_dadj=True):
    """(dem [B, T, S], dadj [B, S, S] or None) from the cotangent of the
    final alpha, replaying the recursion in reverse."""
    B, T, S = traj.shape
    lab = has_lab > 0.0
    lens = lengths.view(B, 1)
    g = g_final
    dem = [None] * T
    dadj = torch.zeros_like(adj_exp) if need_dadj else None
    for t in reversed(range(T)):
        if t > 0:
            prev = traj[:, t - 1]
            sh = torch.clamp(torch.amax(prev, dim=1, keepdim=True), min=NEG)
            e = torch.exp(prev - sh)
        else:
            e = _start_e(start)
        z = _bmv(adj_exp, e)
        live = (t < lens) | (t == 0)
        ga = torch.where(live & (z > 0.0) & lab, g, 0.0)
        dem[t] = ga
        dz = ga / torch.clamp(z, min=_FLOOR)
        if need_dadj:
            dadj = dadj + dz[:, :, None] * e[:, None, :]
        if t > 0:
            g = _bmv_t(adj_exp, dz) * e + torch.where(live, 0.0, g)
    return torch.stack(dem, dim=1), dadj


def _check(name, em_or_traj, adj, start, has_lab, lengths):
    _build.require_cuda(name, em_or_traj, adj, start, has_lab, lengths)
    B, T, S = em_or_traj.shape
    _build.require(f"{name} states", em_or_traj, (B, T, S), torch.float32)
    _build.require(f"{name} adj_exp", adj, (B, S, S), torch.float32)
    _build.require(f"{name} start", start, (B, S), torch.float32)
    _build.require(f"{name} has_lab", has_lab, (B, S), torch.float32)
    _build.require(f"{name} lengths", lengths, (B,), torch.int32)
    if T < 1:
        raise ValueError(f"{name} needs at least one frame")
    return B, T, S


def dense_scan_fwd_cuda(em_state, adj_exp, start, has_lab, lengths):
    """Launch ``dense_scan_fwd``: em_state [B, T, S], adj_exp [B, S, S],
    start/has_lab [B, S] float32, lengths [B] int32 -> traj [B, T, S]."""
    B, T, S = _check("dense_scan_fwd", em_state, adj_exp, start, has_lab, lengths)
    traj = torch.empty((B, T, S), dtype=torch.float32, device=em_state.device)
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(em_state.device):
        err = lib.dense_scan_fwd(
            em_state.data_ptr(), adj_exp.data_ptr(), start.data_ptr(),
            has_lab.data_ptr(), lengths.data_ptr(), traj.data_ptr(),
            B, T, S, _build.MAX_SMEM, _build.stream_handle(em_state),
        )
    _build.check(lib, err, "dense_scan_fwd")
    _build.LAUNCHES["dense_scan_fwd"] += 1
    return traj


def dense_scan_bwd_cuda(traj, adj_exp, start, has_lab, lengths, g_final,
                        need_dadj=True):
    """Launch ``dense_scan_bwd``: traj [B, T, S], adj_exp [B, S, S],
    start/has_lab/g_final [B, S] float32, lengths [B] int32 ->
    (dem [B, T, S], dadj [B, S, S] or None)."""
    B, T, S = _check("dense_scan_bwd", traj, adj_exp, start, has_lab, lengths)
    _build.require_cuda("dense_scan_bwd", traj, g_final)
    _build.require("dense_scan_bwd g_final", g_final, (B, S), torch.float32)
    dem = torch.empty((B, T, S), dtype=torch.float32, device=traj.device)
    dadj = torch.empty_like(adj_exp) if need_dadj else None
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(traj.device):
        err = lib.dense_scan_bwd(
            traj.data_ptr(), adj_exp.data_ptr(), start.data_ptr(),
            has_lab.data_ptr(), lengths.data_ptr(), g_final.data_ptr(),
            dem.data_ptr(), dadj.data_ptr() if need_dadj else None,
            B, T, S, _build.MAX_SMEM, _build.stream_handle(traj),
        )
    _build.check(lib, err, "dense_scan_bwd")
    _build.LAUNCHES["dense_scan_bwd"] += 1
    return dem, dadj


class _DenseScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em_state, adj_exp, start, has_lab, lengths):
        em_state = em_state.to(torch.float32).contiguous()
        adj_exp = adj_exp.to(torch.float32).contiguous()
        start = start.to(torch.float32).contiguous()
        has_lab = has_lab.to(torch.float32).contiguous()
        lengths = lengths.to(device=em_state.device, dtype=torch.int32).contiguous()
        if _build.on_cuda(em_state):
            traj = dense_scan_fwd_cuda(em_state, adj_exp, start, has_lab, lengths)
        else:
            traj = dense_scan_fwd_plain(em_state, adj_exp, start, has_lab, lengths)
        ctx.save_for_backward(traj, adj_exp, start, has_lab, lengths)
        return traj[:, -1].clone()

    @staticmethod
    def backward(ctx, g_final):
        traj, adj_exp, start, has_lab, lengths = ctx.saved_tensors
        g_final = g_final.to(torch.float32).contiguous()
        need_dadj = ctx.needs_input_grad[1]
        if _build.on_cuda(traj):
            dem, dadj = dense_scan_bwd_cuda(traj, adj_exp, start, has_lab,
                                            lengths, g_final, need_dadj)
        else:
            dem, dadj = dense_scan_bwd_plain(traj, adj_exp, start, has_lab,
                                             lengths, g_final, need_dadj)
        return dem, dadj, None, None, None


def dense_scan(em_state, adj_exp, start, has_lab, lengths):
    """Final alpha [B, S] of the dense-adjacency recursion.

    Args:
      em_state: [B, T, S] per-state emissions.
      adj_exp: [B, S, S] — adj_exp[b, u, s] = sum over arcs s -> u of e^w.
      start: [B, S] 0-or-NEG start potentials.
      has_lab: [B, S] {0, 1}: states that may hold mass.
      lengths: [B] int input lengths (frame 0 is applied even at 0).
    Differentiable in ``em_state`` and ``adj_exp``.
    """
    return _DenseScan.apply(em_state, adj_exp, start, has_lab, lengths)
