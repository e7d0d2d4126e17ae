"""One step of the sparse-arc lattice scan, with its VJP.

Counterpart of ``seg_lse`` in ``gtn_applications_tpu/ops/seglse_pallas.py``
(Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel``).  The module keeps
the JAX file's name; the kernels are CUDA C++ for Hopper
(``csrc/sparse_scan.cu``, beside the whole sparse scan):

    new[b, s] = logsumexp over arcs a with dst[a] == s of
                (alpha[b, src[a]] + w[a]) + em[a]

Each destination is shifted by its own largest contribution, and
contributions at or below ``DEAD`` weigh exactly 0, as in
``semiring.segment_logsumexp`` (the CPU route of the JAX package): a state
with no live contribution is NEG.  The VJP is the exact posterior
``exp(c[a] - m) / z * g[dst[a]]``, formed from the destination's shift m
and sum z as autodiff of the plain version forms it (recomputed: the
backward needs no residual but alpha), zero where the contribution is
dead or the destination empty, so no gradient leaks through unreachable
states.
(JAX's Pallas pair shifts by the tile's running max and does not mask
dead states; the two agree wherever the cotangent of a dead state is 0,
which is every use in a lattice score.)

``src``, ``dst``, ``w`` and ``em`` are ``[Ba, A]``, each with Ba in
{1, B} independently; a shared input's gradient is summed over the batch.
An endpoint outside [0, S) drops its arc (JAX pads with -1).  On CUDA
tensors the wrapper launches the kernels; on CPU tensors it runs their
plain versions.

Both kernels walk the arcs grouped by destination, and the backward sums
``dalpha`` by source, through index tables built once per table on the
table's device (``arc_index``): no atomics, so the results are
deterministic.
"""

from typing import NamedTuple, Optional

import torch

from . import _build
from .semiring import DEAD, NEG

# as the JAX module: a normal fp32 number
_FLOOR = 1e-30


class ArcIndex(NamedTuple):
    """Arcs grouped by destination, and the groups by source and label.

    ``order[r, k]`` is the arc at position k of the destination-sorted
    order of row r (rows: 1 for a shared structure, else B); ``dptr``
    [rows, S + 1] delimits each destination's arcs in that order (arcs
    without a valid destination come last, past ``dptr[:, S]``); ``src``
    and ``label`` are the sorted arcs' endpoints (-1 where invalid);
    ``sptr``/``sorder`` and ``lptr``/``lorder`` list the sorted positions
    of each source state and each label."""

    order: torch.Tensor
    dptr: torch.Tensor
    src: torch.Tensor
    sptr: torch.Tensor
    sorder: torch.Tensor
    label: Optional[torch.Tensor] = None
    lptr: Optional[torch.Tensor] = None
    lorder: Optional[torch.Tensor] = None

    @property
    def batched(self):
        return self.order.shape[0] > 1


def _group(keys, n):
    """(order, ptr) of ``keys [rows, A]`` grouped by value in [0, n); keys
    outside go last.  int64 order, int32 ptr [rows, n + 1]."""
    k = torch.where((keys >= 0) & (keys < n), keys, n)
    order = torch.argsort(k, dim=1, stable=True)
    counts = torch.zeros(k.shape[0], n + 1, dtype=torch.int64, device=k.device)
    counts.scatter_add_(1, k, torch.ones_like(k))
    ptr = torch.zeros(k.shape[0], n + 1, dtype=torch.int64, device=k.device)
    ptr[:, 1:] = torch.cumsum(counts[:, :n], dim=1)
    return order, ptr.to(torch.int32)


def arc_index(src, dst, S, label=None, C=0):
    """The ``ArcIndex`` of ``src``/``dst`` (and ``label`` over C channels)
    ``[Ba, A]``, on their device."""
    rows = max(src.shape[0], dst.shape[0], 1 if label is None else label.shape[0])
    A = src.shape[-1]
    src = src.long().expand(rows, A)
    dst = dst.long().expand(rows, A)
    order, dptr = _group(dst, S)
    src_s = src.gather(1, order)
    src_s = torch.where((src_s >= 0) & (src_s < S), src_s, -1)
    sorder, sptr = _group(src_s, S)
    fields = dict(order=order, dptr=dptr.contiguous(),
                  src=src_s.to(torch.int32).contiguous(), sptr=sptr.contiguous(),
                  sorder=sorder.to(torch.int32).contiguous())
    if label is not None:
        lab_s = label.long().expand(rows, A).gather(1, order)
        lab_s = torch.where((lab_s >= 0) & (lab_s < C), lab_s, -1)
        lorder, lptr = _group(lab_s, C)
        fields.update(label=lab_s.to(torch.int32).contiguous(), lptr=lptr.contiguous(),
                      lorder=lorder.to(torch.int32).contiguous())
    return ArcIndex(**fields)


def take(x, order):
    """``x [Bx, A]`` in the sorted arc order ``order [rows, A]``:
    [max(Bx, rows), A], contiguous float32."""
    rows = max(x.shape[0], order.shape[0])
    A = x.shape[-1]
    return x.to(torch.float32).expand(rows, A).gather(
        1, order.expand(rows, A)).contiguous()


def untake(xs, order):
    """Inverse of ``take`` for ``xs [B, A]``: back to the arcs' order."""
    B, A = xs.shape
    return torch.zeros_like(xs).scatter_(1, order.expand(B, A), xs)


def sum_to(x, rows):
    """A per-sample gradient [B, ...] summed to an input of ``rows`` rows."""
    return x.sum(0, keepdim=True) if rows == 1 and x.shape[0] != 1 else x


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _contrib(alpha, src, w, em):
    """c[b, a] = (alpha[b, src[a]] + w[a]) + em[a]; NEG where src is
    outside [0, S)."""
    B, S = alpha.shape
    A = src.shape[-1]
    src = src.long().expand(B, A)
    ok = (src >= 0) & (src < S)
    a = torch.where(ok, alpha.gather(1, torch.where(ok, src, 0)), NEG)
    return (a + w) + em


def _dst_keys(dst, B, S):
    """Destinations [B, A] with invalid ones sent to the extra segment S."""
    dst = dst.long().expand(B, dst.shape[-1])
    return torch.where((dst >= 0) & (dst < S), dst, S)


def _segments(alpha, src, dst, w, em):
    """(c [B, A], keys [B, A], e = exp(c - m[dst]) masked [B, A],
    m [B, S + 1], z [B, S + 1]) of one step; segment S gathers the arcs
    without a valid destination."""
    B, S = alpha.shape
    c = _contrib(alpha, src, w, em)
    keys = _dst_keys(dst, B, S)
    m = torch.full((B, S + 1), NEG, dtype=c.dtype, device=c.device)
    m = torch.clamp(m.scatter_reduce(1, keys, c, "amax"), min=NEG)
    e = torch.where(c > DEAD, torch.exp(c - m.gather(1, keys)), 0.0)
    z = torch.zeros_like(m).scatter_add(1, keys, e)
    return c, keys, e, m, z


def seg_lse_fwd_plain(alpha, src, dst, w, em):
    """new [B, S] (see the module docstring)."""
    S = alpha.shape[1]
    _, _, _, m, z = _segments(alpha, src, dst, w, em)
    out = torch.where(z > 0.0, m + torch.log(torch.clamp(z, min=_FLOOR)), NEG)
    return out[:, :S].contiguous()


def seg_lse_bwd_plain(alpha, src, dst, w, em, g):
    """(dalpha [B, S], dcontrib [B, A]) from the cotangent ``g`` of the
    step's output."""
    B, S = alpha.shape
    _, keys, e, _, z = _segments(alpha, src, dst, w, em)
    zd = z.gather(1, keys)
    gd = torch.cat([g, torch.zeros_like(g[:, :1])], 1).gather(1, keys)
    dc = torch.where(zd > 0.0, e / torch.where(zd > 0.0, zd, 1.0) * gd, 0.0)
    srcs = src.long().expand(B, src.shape[-1])
    skeys = torch.where((srcs >= 0) & (srcs < S), srcs, S)
    dalpha = torch.zeros(B, S + 1, dtype=dc.dtype, device=dc.device)
    return dalpha.scatter_add(1, skeys, dc)[:, :S].contiguous(), dc


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check(name, alpha, idx, *arc_fields):
    B, S = alpha.shape
    A = idx.order.shape[1]
    _build.require_cuda(name, alpha, idx.dptr, idx.src, *arc_fields)
    _build.require(f"{name} alpha", alpha, (B, S), torch.float32)
    if idx.order.shape[0] not in (1, B) or idx.dptr.shape[1] != S + 1:
        raise ValueError(f"{name}: the arc index does not fit alpha {tuple(alpha.shape)}")
    for x in arc_fields:
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != A \
                or x.shape[0] not in (1, B):
            raise ValueError(f"{name}: arc fields must be float32 [1 or {B}, {A}]")
    if 4 * S > _build.MAX_SMEM:
        raise ValueError(f"{name}: S={S} states exceed shared memory")
    return B, S, A


def seg_lse_fwd_cuda(alpha, w_s, em_s, idx):
    """Launch ``seg_lse_fwd``: alpha [B, S]; w_s/em_s [1 or B, A] in the
    sorted order of ``idx`` (``take``) -> new [B, S]."""
    B, S, A = _check("seg_lse_fwd", alpha, idx, w_s, em_s)
    out = torch.empty_like(alpha)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(alpha.device):
        err = lib.seg_lse_fwd(
            alpha.data_ptr(), idx.dptr.data_ptr(), idx.src.data_ptr(),
            w_s.data_ptr(), em_s.data_ptr(), out.data_ptr(),
            B, S, A, int(idx.batched), int(w_s.shape[0] == B > 1),
            int(em_s.shape[0] == B > 1), _build.stream_handle(alpha),
        )
    _build.check(lib, err, "seg_lse_fwd")
    _build.LAUNCHES["seg_lse_fwd"] += 1
    return out


def seg_lse_bwd_cuda(alpha, w_s, em_s, idx, g):
    """Launch ``seg_lse_bwd`` with the cotangent g [B, S] of the step's
    output -> (dalpha [B, S], dcontrib [B, A] in the sorted order of
    ``idx``)."""
    B, S, A = _check("seg_lse_bwd", alpha, idx, w_s, em_s)
    _build.require_cuda("seg_lse_bwd", g, idx.sptr, idx.sorder)
    _build.require("seg_lse_bwd g", g, (B, S), torch.float32)
    dalpha = torch.empty_like(alpha)
    dcontrib = torch.empty((B, A), dtype=torch.float32, device=alpha.device)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(alpha.device):
        err = lib.seg_lse_bwd(
            alpha.data_ptr(), g.data_ptr(), idx.dptr.data_ptr(),
            idx.src.data_ptr(), w_s.data_ptr(), em_s.data_ptr(),
            idx.sptr.data_ptr(), idx.sorder.data_ptr(), dalpha.data_ptr(),
            dcontrib.data_ptr(), B, S, A, int(idx.batched),
            int(w_s.shape[0] == B > 1), int(em_s.shape[0] == B > 1),
            _build.stream_handle(alpha),
        )
    _build.check(lib, err, "seg_lse_bwd")
    _build.LAUNCHES["seg_lse_bwd"] += 1
    return dalpha, dcontrib


class _SegLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, w, em, src, dst, idx):
        alpha = alpha.to(torch.float32).contiguous()
        w = w.to(torch.float32)
        em = em.to(torch.float32)
        if _build.on_cuda(alpha):
            if idx is None:
                idx = arc_index(src, dst, alpha.shape[1])
            out = seg_lse_fwd_cuda(alpha, take(w, idx.order), take(em, idx.order), idx)
        else:
            out = seg_lse_fwd_plain(alpha, src, dst, w, em)
        ctx.save_for_backward(alpha, w, em, src, dst)
        ctx.idx = idx
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, w, em, src, dst = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if _build.on_cuda(alpha):
            idx = ctx.idx
            dalpha, dc_s = seg_lse_bwd_cuda(alpha, take(w, idx.order),
                                            take(em, idx.order), idx, g)
            dc = untake(dc_s, idx.order)
        else:
            dalpha, dc = seg_lse_bwd_plain(alpha, src, dst, w, em, g)
        dw = sum_to(dc, w.shape[0]) if ctx.needs_input_grad[1] else None
        dem = sum_to(dc, em.shape[0]) if ctx.needs_input_grad[2] else None
        return dalpha, dw, dem, None, None, None


def seg_lse(alpha, src, dst, w, em, idx=None):
    """alpha [B, S]; src/dst/w/em [Ba, A], each with Ba in {1, B}
    independently -> new [B, S].  Differentiable in alpha, w and em.
    ``idx`` is ``arc_index(src, dst, S)`` where the caller already has it
    (CUDA only)."""
    as2d = lambda x: x[None] if x.dim() == 1 else x  # noqa: E731
    return _SegLse.apply(alpha, as2d(w), as2d(em), as2d(src), as2d(dst), idx)
