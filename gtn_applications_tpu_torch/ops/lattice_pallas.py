"""CTC lattice score with a hand-written gradient, as a kernel pair.

Counterpart of ``gtn_applications_tpu/ops/lattice_pallas.py``
(``ctc_score_pallas`` and its Pallas kernels ``_ctc_fwd_kernel`` /
``_ctc_bwd_kernel``).  The module keeps the JAX file's name so each port
file sits beside its reference; the kernels are CUDA C++ for Hopper
(``csrc/ctc.cu``), not Pallas.

``ctc_score_kernel`` is one ``torch.autograd.Function`` for both devices,
differentiable in the log-probabilities ``lp [B, T, C]``: state s of sample
b emits ``em[b, t, s] = lp[b, t, labels[b, s]]`` (0 where the label is
outside [0, C)).  Its forward computes the ``[B, T, S]`` alpha trajectory
and takes the final score as ``_final_score`` does in JAX; its backward
runs the time-reversed beta recursion for the posterior gradient with
respect to em and sums it by label into d lp.  On CUDA tensors the two
kernels read lp by label themselves (``ctc_alpha_cuda``, ``ctc_grad_cuda``:
the gather, JAX's ``_gather_fwd_kernel``, moved into their emission copies)
and the backward ends in ``gathers.gather_bwd_cuda``: three launches a
forward and backward.  On CPU tensors ``gather_channels_plain`` feeds
``ctc_alpha_plain`` and ``ctc_grad_plain``, then
``gather_channels_bwd_plain``.  The layout is ``[B, T, S]`` with S
unpadded: the TPU's ``[T, B, S_pad]`` transpose and 128-lane padding
existed only for its tiling.  A caller that holds em already passes it as
lp with identity labels (``arange(S)``, C = S).

The backward kernel runs a sample's recursion on one warp where S <= 32
(route "warp": neighbours by shuffles, no block barrier; a second warp
takes the posterior), else on a warp for each 32 states that pass their
edge lanes through shared memory (route "block", one barrier a frame);
``grad_plan`` gives the route and layout the kernel takes.  The forward
kernel runs that block route mirrored (neighbours from the lanes below),
on one warp with no barrier where S <= 32; ``alpha_plan`` gives its
layout.

``ctc_score_chunked`` runs the same pair a chunk of frames at a time
(the chunk calls of both kernels, ``csrc/ctc.cu``): frames [t0, t0 + n)
of lp are read in place, with lp's own T stride, and lens relative to
t0 (a sample's live frames in the chunk are len - t0, clamped into [0,
n]).  The forward (#1) takes ``alpha_in`` [B, S], the alpha of frame t0 -
1 (less its shift, below): frame 0 of the chunk is em[t0] +
lse3(alpha_in, shift1, skip ? shift2) where t0 < len, else alpha_in
frozen; later frames freeze at t >= len as in the whole-T call;
``alpha_out`` [B, S] takes the chunk's last alpha, the next chunk's
``alpha_in``.  The backward (#2) starts its
beta at ``beta_in`` [B, S] (accept for the last chunk, else the beta
carried back from the chunk after it) and writes ``beta_out`` [B, S],
the beta after the transition of the chunk's frame 0, which is the
accept of the chunk before it; a sample with len <= t0 emits 0 in the
chunk and passes its beta through.

The chunk mode keeps alpha and beta growing over one chunk's frames, not
over T: #1 takes its carried row less ``carry_shift`` (its largest
entry), written to ``shift_out`` [B], and the forward adds those shifts
up in float64 into the score; #2, called without a score, takes beta_in
less its own shift, measures the posterior against the chunk's own
score, Z = lse(alpha + beta) at its last frame, and divides each frame's
row by its sum, so that the rounding alpha and beta gather over a chunk
cancels in each frame; a sample whose Z is dead (an infeasible target,
whose gradient JAX's chunked scan also makes 0) emits 0.  The whole-T
route keeps alpha and beta of |score| itself: at |score| ~ 10^4 float32
holds them to ~10^-3, which exp turns into relative errors of the
gradient.  The plain versions take the same options (``t0`` and
``frames`` of ``gather_channels_plain``, ``alpha_in`` of
``ctc_alpha_plain``, ``return_beta`` and score None of
``ctc_grad_plain``).
"""

import torch
import torch.nn.functional as F

from . import _build
from .gathers import gather_bwd_cuda, gather_channels_bwd_plain, gather_channels_plain
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


def carry_shift(x):
    """The largest entry of each sample's row x [B, S], 0 where every entry
    is dead (<= NEG / 2): what a chunk call takes off its carried row."""
    m = torch.amax(x, dim=1)
    return torch.where(m > NEG / 2, m, torch.zeros_like(m))


def ctc_alpha_plain(em, start, skip, lens, alpha_in=None):
    """Alpha trajectory [B, T, S]: alpha[0] = start + em[0], then
    alpha[t] = em[t] + lse3(alpha, shift1, skip ? shift2), frozen at
    t >= lens.  With ``alpha_in`` [B, S] (the chunk mode; ``start``
    unread) alpha_in less ``carry_shift(alpha_in)`` stands for alpha[-1]
    and frame 0 is a transition too: the rows grow over one chunk's
    frames, not over T, and come out less that shift."""
    B, T, _ = em.shape
    skip = skip > 0.5
    lens = lens.view(B, 1)
    if alpha_in is None:
        alpha = start + em[:, 0]
        out, first = [alpha], 1
    else:
        alpha, out, first = alpha_in - carry_shift(alpha_in)[:, None], [], 0
    for t in range(first, T):
        jump = torch.where(skip, _shift_states(alpha, 2), NEG)
        new = em[:, t] + _lse3(alpha, _shift_states(alpha, 1), jump)
        alpha = torch.where(t < lens, new, alpha)
        out.append(alpha)
    return torch.stack(out, dim=1)


def ctc_grad_plain(em, alpha, accept, skip, lens, score, g, return_beta=False):
    """d score / d em, scaled by g [B]: the beta recursion run backwards
    from ``accept`` (a chunk's ``beta_in``), emitting exp(min(alpha + beta
    - score, 0)) * g; with ``return_beta`` also the beta after frame 0's
    transition (the chunk's ``beta_out``).

    ``score`` None is the chunk mode: beta starts at beta_in less
    ``carry_shift(beta_in)``; p_t = exp(min(alpha[t] + beta[t] - Z, 0)),
    Z = lse(alpha + beta) at the call's last frame (a sample's frozen
    frame where it ends earlier) in place of the score; and each frame's
    row is p_t g / sum(p_t), the frame's own normaliser, 0 where Z is dead
    (an infeasible target)."""
    B, T, _ = em.shape
    skip = skip > 0.5
    lens = lens.view(B, 1)
    beta = accept
    if score is None:
        beta = accept - carry_shift(accept)[:, None]
        z = _final_score(alpha[:, -1], beta)
        g = torch.where(z > NEG / 2, g, 0.0)
    grads = [None] * T
    for t in reversed(range(T)):
        live = t < lens
        if score is None:
            post = torch.exp(torch.clamp(alpha[:, t] + beta - z[:, None], max=0.0))
            r = post.sum(dim=1, keepdim=True)
            post = post * torch.where(r > 0, g[:, None] / torch.where(r > 0, r, 1.0), 0.0)
        else:
            post = torch.exp(torch.clamp(alpha[:, t] + beta - score[:, None], max=0.0))
            post = post * g[:, None]
        grads[t] = torch.where(live, post, 0.0)
        eb = em[:, t] + beta
        jump = _shift_states_rev(torch.where(skip, eb, NEG), 2)
        new = _lse3(eb, _shift_states_rev(eb, 1), jump)
        beta = torch.where(live, new, beta)
    grad = torch.stack(grads, dim=1)
    return (grad, beta) if return_beta else grad


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


def _states(name, lp, labels, *tensors):
    """(B, T, S, C) of a CTC kernel's lp [B, T, C] float32 and labels [B, S]
    int32; raises on what the kernels do not take."""
    _build.require_cuda(name, lp, labels, *tensors)
    if lp.dim() != 3 or labels.dim() != 2:
        raise ValueError(f"{name}: lp must be [B, T, C] and labels [B, S]")
    B, T, C = lp.shape
    S = labels.shape[1]
    _build.require(f"{name} lp", lp, (B, T, C), torch.float32)
    _build.require(f"{name} labels", labels, (B, S), torch.int32)
    if C < 1:
        raise ValueError(f"{name}: lp has no channels")
    # the backward holds four state vectors of S floats in shared memory
    if 4 * S * 4 > _build.MAX_SMEM:
        raise ValueError(f"{name}: S={S} states do not fit in shared memory")
    return B, T, S, C


def _chunk_frames(name, T, t0, frames):
    """The frames [t0, t0 + n) of a chunk call on lp of T frames."""
    n = T - t0 if frames is None else frames
    if t0 < 0 or n < 1 or t0 + n > T:
        raise ValueError(f"{name}: frames [{t0}, {t0 + n}) outside lp's {T}")
    return n


def ctc_alpha_cuda(lp, labels, start, skip, lens, t0=0, frames=None, alpha_in=None,
                   alpha_out=None, out=None, shift_out=None):
    """Launch ``ctc_alpha``: lp [B, T, C] float32, labels [B, S] int32 (em
    read by label), start/skip [B, S] float32, lens [B] int32 -> alpha
    [B, T, S].  The rest is the chunk call: frames [t0, t0 + frames) of
    lp, from ``alpha_in`` [B, S] (else from start, whose frame 0 ignores
    lens), less its ``carry_shift``, into ``out`` [B, frames, S] (a new
    tensor if None), the last alpha also into ``alpha_out`` [B, S] and the
    shift into ``shift_out`` [B]."""
    B, T, S, C = _states("ctc_alpha", lp, labels, skip, lens)
    _build.require("ctc_alpha skip", skip, (B, S), torch.float32)
    _build.require("ctc_alpha lens", lens, (B,), torch.int32)
    n = _chunk_frames("ctc_alpha", T, t0, frames)
    if alpha_in is None:
        _build.require_cuda("ctc_alpha", lp, start)
        _build.require("ctc_alpha start", start, (B, S), torch.float32)
    for name, x, shape in (("alpha_in", alpha_in, (B, S)), ("alpha_out", alpha_out, (B, S)),
                           ("shift_out", shift_out, (B,))):
        if x is not None:
            _build.require_cuda("ctc_alpha", lp, x)
            _build.require(f"ctc_alpha {name}", x, shape, torch.float32)
    if shift_out is not None and alpha_in is None:
        raise ValueError("ctc_alpha: shift_out without alpha_in")
    if out is None:
        out = torch.empty((B, n, S), dtype=torch.float32, device=lp.device)
    _build.require_cuda("ctc_alpha", lp, out)
    _build.require("ctc_alpha out", out, (B, n, S), torch.float32)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _build.load_library("ctc")
    with torch.cuda.device(lp.device):
        err = lib.ctc_alpha(
            lp.data_ptr(), labels.data_ptr(), ptr(start if alpha_in is None else None),
            ptr(alpha_in), skip.data_ptr(), lens.data_ptr(), out.data_ptr(), ptr(alpha_out),
            ptr(shift_out), B, T, t0, n, S, C, _build.stream_handle(lp),
        )
    _build.check(lib, err, "ctc_alpha")
    _build.LAUNCHES["ctc_alpha"] += 1
    return out


def ctc_grad_cuda(lp, labels, alpha, accept, skip, lens, score, g, t0=0, beta_out=None,
                  out=None):
    """Launch ``ctc_grad``: lp [B, T, C] float32, labels [B, S] int32 (em
    read by label), alpha [B, T, S], accept/skip [B, S] float32, lens [B]
    int32, score/g [B] float32 -> grad [B, T, S], d score / d em.  The
    rest is the chunk call: alpha [B, n, S] holds frames [t0, t0 + n) of
    lp, beta starts at ``accept`` (the chunk's beta_in) and its value
    after frame 0's transition goes to ``beta_out`` [B, S]; score None is
    the chunk mode of ``ctc_grad_plain``; the grad rows go to frames [t0,
    t0 + n) of ``out`` [B, T, S] (a new [B, n, S] tensor if None)."""
    B, T, S, C = _states("ctc_grad", lp, labels, alpha, accept, skip, lens, g)
    n = alpha.shape[1] if alpha.dim() == 3 else -1
    _chunk_frames("ctc_grad", T, t0, n)
    _build.require("ctc_grad alpha", alpha, (B, n, S), torch.float32)
    _build.require("ctc_grad accept", accept, (B, S), torch.float32)
    _build.require("ctc_grad skip", skip, (B, S), torch.float32)
    _build.require("ctc_grad lens", lens, (B,), torch.int32)
    if score is not None:
        _build.require_cuda("ctc_grad", lp, score)
        _build.require("ctc_grad score", score, (B,), torch.float32)
    _build.require("ctc_grad g", g, (B,), torch.float32)
    if beta_out is not None:
        _build.require_cuda("ctc_grad", lp, beta_out)
        _build.require("ctc_grad beta_out", beta_out, (B, S), torch.float32)
    if out is None:
        grad, row0, rows = torch.empty((B, n, S), dtype=torch.float32, device=lp.device), 0, n
    else:
        _build.require_cuda("ctc_grad", lp, out)
        _build.require("ctc_grad out", out, (B, T, S), torch.float32)
        grad, row0, rows = out, t0, T
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _build.load_library("ctc")
    with torch.cuda.device(lp.device):
        err = lib.ctc_grad(
            lp.data_ptr(), labels.data_ptr(), alpha.data_ptr(), accept.data_ptr(),
            skip.data_ptr(), lens.data_ptr(), ptr(score), g.data_ptr(),
            grad.data_ptr() + row0 * S * 4, ptr(beta_out),
            B, T, t0, n, rows, S, C, _build.stream_handle(lp),
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
    def forward(ctx, log_probs, labels, start, accept, skip_ok, input_lengths):
        lp = log_probs.to(torch.float32).contiguous()
        labels = labels.to(device=lp.device, dtype=torch.int32).contiguous()
        start = start.to(torch.float32).contiguous()
        accept = accept.to(torch.float32).contiguous()
        skip = skip_ok.to(torch.float32).contiguous()
        lens = input_lengths.to(device=lp.device, dtype=torch.int32).contiguous()
        if _build.on_cuda(lp):
            alpha = ctc_alpha_cuda(lp, labels, start, skip, lens)
        else:
            alpha = ctc_alpha_plain(gather_channels_plain(lp, labels), start, skip, lens)
        score = _final_score(alpha[:, -1], accept)
        ctx.save_for_backward(lp, labels, alpha, accept, skip, lens, score)
        return score

    @staticmethod
    def backward(ctx, g):
        lp, labels, alpha, accept, skip, lens, score = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        C = lp.shape[2]
        if _build.on_cuda(lp):
            grad = ctc_grad_cuda(lp, labels, alpha, accept, skip, lens, score, g)
            dlp = gather_bwd_cuda(grad, labels, C)
        else:
            em = gather_channels_plain(lp, labels)
            grad = ctc_grad_plain(em, alpha, accept, skip, lens, score, g)
            dlp = gather_channels_bwd_plain(grad, labels, C)
        return dlp, None, None, None, None, None


def chunk_spans(T, chunk):
    """(t0, frames) of each call of the chunked route: frame 0 (the init)
    with the first ``chunk`` frames after it, then ``chunk`` frames a call,
    the last one short.  This is JAX's split (frame 0, then frames 1..T-1
    in chunks) with frame 0 joined to the first chunk's call."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, not {chunk}")
    spans = [(0, min(1 + chunk, T))]
    while spans[-1][0] + spans[-1][1] < T:
        t0 = spans[-1][0] + spans[-1][1]
        spans.append((t0, min(chunk, T - t0)))
    return spans


def _alpha_span(lp, labels, start, skip, lens, t0, n, alpha_in, alpha_out, out, shift_out):
    """The alphas of frames [t0, t0 + n) into ``out`` [B, n, S] in the
    chunk mode (the last row also into ``alpha_out``, alpha_in's shift
    into ``shift_out``): #1 on CUDA tensors, the plain version on CPU
    tensors."""
    if _build.on_cuda(lp):
        return ctc_alpha_cuda(lp, labels, start, skip, lens, t0, n, alpha_in, alpha_out, out,
                              shift_out)
    em = gather_channels_plain(lp, labels, t0, n)
    out.copy_(ctc_alpha_plain(em, start, skip, lens - t0, alpha_in))
    if alpha_out is not None:
        alpha_out.copy_(out[:, -1])
    if shift_out is not None:
        shift_out.copy_(carry_shift(alpha_in))
    return out


def _grad_span(lp, labels, alpha, beta_in, skip, lens, g, t0, beta_out, out):
    """The posterior of frames [t0, t0 + n) into those frames of ``out``
    [B, T, S] from beta_in in the chunk mode, beta after frame t0's
    transition into ``beta_out``: #2 on CUDA tensors, the plain version on
    CPU tensors."""
    if _build.on_cuda(lp):
        return ctc_grad_cuda(lp, labels, alpha, beta_in, skip, lens, None, g, t0, beta_out, out)
    n = alpha.shape[1]
    em = gather_channels_plain(lp, labels, t0, n)
    grad, beta = ctc_grad_plain(em, alpha, beta_in, skip, lens - t0, None, g, True)
    out[:, t0:t0 + n] = grad
    if beta_out is not None:
        beta_out.copy_(beta)
    return out


class _CTCChunked(torch.autograd.Function):
    """The score of ``_CTCScore`` with O(T / chunk) memory between the
    forward and the backward: the forward runs #1 a chunk at a time into
    one reused [B, chunk + 1, S] buffer and keeps the chunks' last alphas
    [nc, B, S]; the backward walks the chunks in reverse, recomputes a
    chunk's alphas from the boundary before it and runs #2 from the beta
    carried back, filling one [B, T, S] posterior that #4 sums by label
    once.  One sum over the whole posterior, not one a chunk: one launch
    of #4, and a peak below the whole-T route's, which holds the [B, T, S]
    alphas beside that posterior.

    Both kernels run in their chunk mode (the module's docstring): the
    forward's shifts [nc, B] add up in float64 into the score.
    """

    @staticmethod
    def forward(ctx, log_probs, labels, start, accept, skip_ok, input_lengths, chunk):
        lp = log_probs.to(torch.float32).contiguous()
        labels = labels.to(device=lp.device, dtype=torch.int32).contiguous()
        start = start.to(torch.float32).contiguous()
        accept = accept.to(torch.float32).contiguous()
        skip = skip_ok.to(torch.float32).contiguous()
        lens = input_lengths.to(device=lp.device, dtype=torch.int32).contiguous()
        B, T, _ = lp.shape
        S = labels.shape[1]
        spans = chunk_spans(T, chunk)
        buf = lp.new_empty(B * spans[0][1] * S)
        carry = lp.new_empty((len(spans), B, S))
        shift = lp.new_zeros((len(spans), B))
        for i, (t0, n) in enumerate(spans):
            _alpha_span(lp, labels, start, skip, lens, t0, n, carry[i - 1] if i else None,
                        carry[i], buf[:B * n * S].view(B, n, S), shift[i] if i else None)
        score = shift.double().sum(0) + _final_score(carry[-1], accept).double()
        ctx.save_for_backward(lp, labels, start, accept, skip, lens, carry)
        ctx.spans = spans
        return score.float()

    @staticmethod
    def backward(ctx, g):
        lp, labels, start, accept, skip, lens, carry = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        B, T, C = lp.shape
        S = labels.shape[1]
        spans = ctx.spans
        buf = lp.new_empty(B * spans[0][1] * S)
        grad = lp.new_empty((B, T, S))
        beta = accept
        for i in reversed(range(len(spans))):
            t0, n = spans[i]
            alpha = _alpha_span(lp, labels, start, skip, lens, t0, n,
                                carry[i - 1] if i else None, None,
                                buf[:B * n * S].view(B, n, S), None)
            beta_out = lp.new_empty((B, S)) if i else None
            _grad_span(lp, labels, alpha, beta, skip, lens, g, t0, beta_out, grad)
            beta = beta_out
        if _build.on_cuda(lp):
            dlp = gather_bwd_cuda(grad, labels, C)
        else:
            dlp = gather_channels_bwd_plain(grad, labels, C)
        return dlp, None, None, None, None, None, None


def ctc_score_chunked(log_probs, labels, start, accept, skip_ok, input_lengths, chunk=128):
    """``ctc_score_kernel``'s score [B], run ``chunk`` frames a call
    (``chunk_spans``) with the chunks' boundary alphas alone kept for the
    backward (``_CTCChunked``).  No fallback: on CUDA tensors the kernels'
    chunk mode runs or raises."""
    return _CTCChunked.apply(log_probs, labels, start, accept, skip_ok, input_lengths,
                             int(chunk))


def ctc_score_kernel(log_probs, labels, start, accept, skip_ok, input_lengths):
    """Forward score [B] of the banded CTC lattice, differentiable in
    ``log_probs``.

    Args:
      log_probs: [B, T, C] log-probabilities.
      labels: [B, S] int, the channel each state emits (-1 for none: em 0).
      start / accept: [B, S] 0-or-NEG potentials.
      skip_ok: [B, S] {0, 1} mask.
      input_lengths: [B] int.  The t = 0 step ignores it, as the TPU kernel
        does (lengths are at least 1).
    """
    return _CTCScore.apply(log_probs, labels, start, accept, skip_ok, input_lengths)
