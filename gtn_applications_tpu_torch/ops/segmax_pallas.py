"""One tropical (max, +) step of the sparse-arc lattice, with backpointers.

Counterpart of ``seg_max`` in ``gtn_applications_tpu/ops/segmax_pallas.py``
(Pallas kernel ``_kernel``).  The module keeps the JAX file's name; the
kernel is CUDA C++ for Hopper (``csrc/sparse_scan.cu``, beside ``seg_lse``,
walking the same destination-sorted ``arc_index``):

    new[b, s]      = max(NEG, max over arcs a with dst[a] == s of
                              (alpha[b, src[a]] + w[a]) + e[a])
    best_arc[b, s] = the lowest arc id a attaining that maximum, if it is
                     strictly above NEG; else 2^30

The sum is formed in that order, so kernel and plain version agree bit for
bit.  An arc with an endpoint outside [0, S) is dropped (JAX pads with -1
endpoints and NEG weights).  A contribution equal to NEG never wins, and a
state reached only from NEG states stays NEG: float32 absorbs NEG + small.
Ties go to the lowest arc id on the exact maximum, the Pallas kernel's rule
(a strict ``>`` across its arc tiles); JAX's CPU oracle
``sparse.viterbi`` takes the lowest arc within 1e-6 instead.

``src``, ``dst``, ``w`` are ``[Ba, A]`` with Ba in {1, B} each on its own.
Emissions come in one of two modes: per arc, ``em [Ba, A]`` (JAX's
signature); or by label, ``em [B, C]`` (one frame's row) with
``label [Ba, A]``, where ``e[a] = em[b, label[a]]``, 0 for a label outside
[0, C) (``gather_channels``' rule).  The step decode uses the label mode:
it reads each frame's row where JAX builds a ``[T, B, A]`` arc-emission
tensor.  Forward only, as in JAX.  On CUDA tensors the wrapper launches the
kernel; on CPU tensors it runs the plain version.
"""

import torch

from . import _build
from .seglse_pallas import arc_index, take
from .semiring import NEG

BIG = 2**30  # best_arc of a state that no live arc reaches


def _arc_fields(alpha, src, dst, w, em, label):
    """(keys [B, A] with invalid arcs sent to segment S, contributions
    [B, A]) of one step."""
    B, S = alpha.shape
    A = max(x.shape[-1] for x in (src, dst, w))
    src = src.long().expand(B, A)
    dst = dst.long().expand(B, A)
    ok = (src >= 0) & (src < S) & (dst >= 0) & (dst < S)
    if label is None:
        e = em.expand(B, A)
    else:
        C = em.shape[-1]
        lab = label.long().expand(B, A)
        has = (lab >= 0) & (lab < C)
        e = torch.where(has, em.expand(B, C).gather(1, torch.where(has, lab, 0)), 0.0)
    a = alpha.gather(1, torch.where(ok, src, 0))
    return torch.where(ok, dst, S), (a + w) + e


def seg_max_plain(alpha, src, dst, w, em, label=None):
    """(new [B, S], best_arc [B, S] int32) by torch segment reductions."""
    B, S = alpha.shape
    keys, c = _arc_fields(alpha, src, dst, w, em, label)
    m = torch.full((B, S + 1), NEG, dtype=c.dtype, device=c.device)
    m = m.scatter_reduce(1, keys, c, "amax")
    ids = torch.arange(c.shape[1], device=c.device).expand_as(keys)
    win = (keys < S) & (c > NEG) & (c == m.gather(1, keys))
    arc = torch.full((B, S + 1), BIG, dtype=torch.int64, device=c.device)
    arc = arc.scatter_reduce(1, keys, torch.where(win, ids, BIG), "amin")
    return m[:, :S].contiguous(), arc[:, :S].to(torch.int32).contiguous()


def seg_max_cuda(alpha, w_s, em, idx):
    """Launch ``seg_max``: alpha [B, S] float32; w_s [1 or B, A] in the
    sorted order of ``idx`` (``take``).  With ``idx.label`` (an index built
    with labels), em is one frame's row [B, C] whose rows may be strided
    (``em[:, t]`` of [B, T, C]); without, em is [1 or B, A] in the sorted
    order.  -> (new [B, S], best_arc [B, S] int32)."""
    B, S = alpha.shape
    A = idx.order.shape[1]
    _build.require_cuda("seg_max", alpha, w_s, idx.order, idx.dptr, idx.src)
    _build.require("seg_max alpha", alpha, (B, S), torch.float32)
    if idx.order.shape[0] not in (1, B) or idx.dptr.shape[1] != S + 1:
        raise ValueError(f"seg_max: the arc index does not fit alpha {tuple(alpha.shape)}")
    if w_s.dtype != torch.float32 or w_s.dim() != 2 or w_s.shape[1] != A \
            or w_s.shape[0] not in (1, B):
        raise ValueError(f"seg_max: w must be float32 [1 or {B}, {A}]")
    if em.dtype != torch.float32 or em.dim() != 2 or em.device != alpha.device \
            or em.stride(1) != 1:
        raise ValueError("seg_max: em must be a float32 CUDA matrix of unit column stride")
    if idx.label is not None:
        _build.require_cuda("seg_max", alpha, idx.label)
        if em.shape[0] != B:
            raise ValueError(f"seg_max: the emission row must be [{B}, C]")
        C, em_rows, em_ld = em.shape[1], 1, em.stride(0)
    else:
        if em.shape[1] != A or em.shape[0] not in (1, B) or not em.is_contiguous():
            raise ValueError(f"seg_max: per-arc em must be contiguous [1 or {B}, {A}]")
        C, em_rows, em_ld = 0, int(em.shape[0] == B > 1), A
    new = torch.empty_like(alpha)
    arc = torch.empty((B, S), dtype=torch.int32, device=alpha.device)
    label = idx.label.data_ptr() if idx.label is not None else None
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(alpha.device):
        err = lib.seg_max(
            alpha.data_ptr(), idx.dptr.data_ptr(), idx.src.data_ptr(),
            idx.order.data_ptr(), w_s.data_ptr(), label, em.data_ptr(),
            new.data_ptr(), arc.data_ptr(), B, S, A, C, em_ld,
            int(idx.batched), int(w_s.shape[0] == B > 1), em_rows,
            _build.stream_handle(alpha),
        )
    _build.check(lib, err, "seg_max")
    _build.LAUNCHES["seg_max"] += 1
    return new, arc


def seg_max(alpha, src, dst, w, em, idx=None, label=None):
    """alpha [B, S]; src/dst/w [Ba, A], each with Ba in {1, B}
    independently; em [Ba, A] per arc, or [B, C] read by ``label``
    [Ba, A] -> (new [B, S], best_arc [B, S] int32).  ``idx`` is
    ``arc_index(src, dst, S[, label, C])`` where the caller already has it
    (CUDA only)."""
    as2d = lambda x: x[None] if x.dim() == 1 else x  # noqa: E731
    src, dst, w = as2d(src), as2d(dst), as2d(w).to(torch.float32)
    label = None if label is None else as2d(label)
    em = as2d(em).to(torch.float32)
    alpha = alpha.to(torch.float32).contiguous()
    if not _build.on_cuda(alpha):
        return seg_max_plain(alpha, src, dst, w, em, label)
    if idx is None:
        idx = (arc_index(src, dst, alpha.shape[1]) if label is None
               else arc_index(src, dst, alpha.shape[1], label, em.shape[1]))
    if label is None:
        em = take(em, idx.order)
    return seg_max_cuda(alpha, take(w, idx.order), em, idx)
