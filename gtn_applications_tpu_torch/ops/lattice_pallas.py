"""CTC lattice score with a hand-written gradient, as a kernel pair.

Counterpart of ``gtn_applications_tpu/ops/lattice_pallas.py``
(``ctc_score_pallas`` and its Pallas kernels ``_ctc_fwd_kernel`` /
``_ctc_bwd_kernel``).  The module keeps the JAX file's name so each port
file sits beside its reference; the kernels are CUDA C++ for Hopper
(``csrc/ctc.cu``), not Pallas.

``ctc_score_kernel`` is one ``torch.autograd.Function`` for both devices:
its forward computes the ``[B, T, S]`` alpha trajectory (``ctc_alpha_cuda``
on CUDA tensors, ``ctc_alpha_plain`` on CPU tensors) and takes the final
score as ``_final_score`` does in JAX; its backward runs the time-reversed
beta recursion and emits the posterior gradient with respect to the
emissions (``ctc_grad_cuda`` / ``ctc_grad_plain``).  The layout is
``[B, T, S]`` with S unpadded: the TPU's ``[T, B, S_pad]`` transpose and
128-lane padding existed only for its tiling.

The backward kernel runs a sample's recursion on one warp where S <= 32
(route "warp": neighbours by shuffles, no block barrier; a second warp
takes the posterior), else on a warp for each 32 states that pass their
edge lanes through shared memory (route "block", one barrier a frame);
``grad_plan`` gives the route and layout the kernel takes.  The forward
kernel runs that block route mirrored (neighbours from the lanes below),
on one warp with no barrier where S <= 32; ``alpha_plan`` gives its
layout.
"""

import torch
import torch.nn.functional as F

from . import _build
from .semiring import NEG, _FLOOR


def _lse3(a, b, c):
    # exactly the TPU kernel's: max clamped to NEG, sum floored before log
    m = torch.clamp(torch.maximum(torch.maximum(a, b), c), min=NEG)
    r = torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m)
    return m + torch.log(torch.clamp(r, min=_FLOOR))


def _shift_states(x, k):
    """out[:, s] = x[:, s-k], NEG filled."""
    return F.pad(x, (k, 0), value=NEG)[:, : x.shape[1]]


def _shift_states_rev(x, k):
    """out[:, s] = x[:, s+k], NEG filled."""
    return F.pad(x, (0, k), value=NEG)[:, k:]


def ctc_alpha_plain(em, start, skip, lens):
    """Alpha trajectory [B, T, S]: alpha[0] = start + em[0], then
    alpha[t] = em[t] + lse3(alpha, shift1, skip ? shift2), frozen at
    t >= lens."""
    B, T, _ = em.shape
    skip = skip > 0.5
    lens = lens.view(B, 1)
    alpha = start + em[:, 0]
    out = [alpha]
    for t in range(1, T):
        jump = torch.where(skip, _shift_states(alpha, 2), NEG)
        new = em[:, t] + _lse3(alpha, _shift_states(alpha, 1), jump)
        alpha = torch.where(t < lens, new, alpha)
        out.append(alpha)
    return torch.stack(out, dim=1)


def ctc_grad_plain(em, alpha, accept, skip, lens, score, g):
    """d score / d em, scaled by g [B]: the beta recursion run backwards
    from ``accept``, emitting exp(min(alpha + beta - score, 0)) * g."""
    B, T, _ = em.shape
    skip = skip > 0.5
    lens = lens.view(B, 1)
    beta = accept
    grads = [None] * T
    for t in reversed(range(T)):
        live = t < lens
        post = torch.exp(torch.clamp(alpha[:, t] + beta - score[:, None], max=0.0))
        grads[t] = torch.where(live, post * g[:, None], 0.0)
        eb = em[:, t] + beta
        jump = _shift_states_rev(torch.where(skip, eb, NEG), 2)
        new = _lse3(eb, _shift_states_rev(eb, 1), jump)
        beta = torch.where(live, new, beta)
    return torch.stack(grads, dim=1)


# ctc_grad's and ctc_alpha's routes; must match csrc/ctc.cu grad_plan and
# block_plan
GRAD_WARP_MAX_S = 32
GRAD_RING = 8  # route "warp": frames of em and alpha rows in shared memory
GRAD_BLOCK_RING = 4  # route "block": the same
GRAD_RING_SMEM = 200 * 1024  # route "block": the ring's shared memory at most


def _block_plan(S, rows):
    """(warps, K, ring) of a warp for each 32 states at S states (csrc/ctc.cu
    block_plan): W = min(32, ceil(S / 32)) warps, thread i holding states
    i + 32 W k for k < K = ceil(S / 32 W), taken as 16 past 8; ring: the
    frames of ``rows`` rows a sample keeps in shared memory, filled that
    many frames ahead (0 where they do not fit in GRAD_RING_SMEM, and the
    rows are read from global memory)."""
    warps = min(32, -(-S // 32))
    k = -(-S // (32 * warps))
    k = 16 if k > 8 else k
    fits = rows * GRAD_BLOCK_RING * k * 32 * warps * 4 <= GRAD_RING_SMEM
    return warps, k, GRAD_BLOCK_RING if fits else 0


def grad_plan(S):
    """(route, K, warps, ring) of the ``ctc_grad`` kernel at S states:
    "warp" up to GRAD_WARP_MAX_S states (a chain warp whose lane l holds
    states l K + k for k < K = ceil(S / 32), and a helper warp for the
    posterior, a ring of GRAD_RING frames), else "block" (``_block_plan``
    with em and alpha rows)."""
    if S <= GRAD_WARP_MAX_S:
        return "warp", max(1, -(-S // 32)), 2, GRAD_RING
    warps, k, ring = _block_plan(S, 2)
    return "block", k, warps, ring


def alpha_plan(S):
    """(route, K, warps, ring) of the ``ctc_alpha`` kernel at S states:
    ``_block_plan`` with em rows; route "warp" where it takes one warp (the
    exchange all by shuffle, no barrier), else "block" (a warp's lanes 0
    and 1 take the warp below's top lanes through shared memory, one
    barrier a frame)."""
    warps, k, ring = _block_plan(S, 1)
    return "warp" if warps == 1 else "block", k, warps, ring


def _states(name, em, *tensors):
    _build.require_cuda(name, em, *tensors)
    B, T, S = em.shape
    # the backward holds four state vectors of S floats in shared memory
    if 4 * S * 4 > _build.MAX_SMEM:
        raise ValueError(f"{name}: S={S} states do not fit in shared memory")
    return B, T, S


def ctc_alpha_cuda(em, start, skip, lens):
    """Launch ``ctc_alpha``: em [B, T, S], start/skip [B, S] float32,
    lens [B] int32 -> alpha [B, T, S]."""
    B, T, S = _states("ctc_alpha", em, start, skip, lens)
    _build.require("ctc_alpha em", em, (B, T, S), torch.float32)
    _build.require("ctc_alpha start", start, (B, S), torch.float32)
    _build.require("ctc_alpha skip", skip, (B, S), torch.float32)
    _build.require("ctc_alpha lens", lens, (B,), torch.int32)
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=em.device)
    lib = _build.load_library("ctc")
    with torch.cuda.device(em.device):
        err = lib.ctc_alpha(
            em.data_ptr(), start.data_ptr(), skip.data_ptr(), lens.data_ptr(),
            alpha.data_ptr(), B, T, S, _build.stream_handle(em),
        )
    _build.check(lib, err, "ctc_alpha")
    _build.LAUNCHES["ctc_alpha"] += 1
    return alpha


def ctc_grad_cuda(em, alpha, accept, skip, lens, score, g):
    """Launch ``ctc_grad``: em/alpha [B, T, S], accept/skip [B, S] float32,
    lens [B] int32, score/g [B] float32 -> grad [B, T, S]."""
    B, T, S = _states("ctc_grad", em, alpha, accept, skip, lens, score, g)
    _build.require("ctc_grad em", em, (B, T, S), torch.float32)
    _build.require("ctc_grad alpha", alpha, (B, T, S), torch.float32)
    _build.require("ctc_grad accept", accept, (B, S), torch.float32)
    _build.require("ctc_grad skip", skip, (B, S), torch.float32)
    _build.require("ctc_grad lens", lens, (B,), torch.int32)
    _build.require("ctc_grad score", score, (B,), torch.float32)
    _build.require("ctc_grad g", g, (B,), torch.float32)
    grad = torch.empty((B, T, S), dtype=torch.float32, device=em.device)
    lib = _build.load_library("ctc")
    with torch.cuda.device(em.device):
        err = lib.ctc_grad(
            em.data_ptr(), alpha.data_ptr(), accept.data_ptr(),
            skip.data_ptr(), lens.data_ptr(), score.data_ptr(), g.data_ptr(),
            grad.data_ptr(), B, T, S, _build.stream_handle(em),
        )
    _build.check(lib, err, "ctc_grad")
    _build.LAUNCHES["ctc_grad"] += 1
    return grad


def _final_score(alpha_last, accept):
    final = alpha_last + accept
    m = torch.clamp(torch.amax(final, dim=-1), min=NEG)
    return m + torch.log(
        torch.clamp(torch.sum(torch.exp(final - m[:, None]), dim=-1), min=_FLOOR)
    )


class _CTCScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, start, accept, skip_ok, input_lengths):
        em = em.to(torch.float32).contiguous()
        start = start.to(torch.float32).contiguous()
        accept = accept.to(torch.float32).contiguous()
        skip = skip_ok.to(torch.float32).contiguous()
        lens = input_lengths.to(device=em.device, dtype=torch.int32).contiguous()
        if _build.on_cuda(em):
            alpha = ctc_alpha_cuda(em, start, skip, lens)
        else:
            alpha = ctc_alpha_plain(em, start, skip, lens)
        score = _final_score(alpha[:, -1], accept)
        ctx.save_for_backward(em, alpha, accept, skip, lens, score)
        return score

    @staticmethod
    def backward(ctx, g):
        em, alpha, accept, skip, lens, score = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if _build.on_cuda(em):
            grad = ctc_grad_cuda(em, alpha, accept, skip, lens, score, g)
        else:
            grad = ctc_grad_plain(em, alpha, accept, skip, lens, score, g)
        return grad, None, None, None, None


def ctc_score_kernel(em, start, accept, skip_ok, input_lengths):
    """Forward score [B] of the banded CTC lattice, differentiable in ``em``.

    Args:
      em: [B, T, S] per-state emissions.
      start / accept: [B, S] 0-or-NEG potentials.
      skip_ok: [B, S] {0, 1} mask.
      input_lengths: [B] int.  The t = 0 step ignores it, as the TPU kernel
        does (lengths are at least 1).
    """
    return _CTCScore.apply(em, start, accept, skip_ok, input_lengths)
