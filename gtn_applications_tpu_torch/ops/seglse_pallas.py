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
and sum z as autodiff of the plain version forms it, zero where the
contribution is dead or the destination empty, so no gradient leaks
through unreachable states.  The kernel route saves m and z in the
forward ([B, S] each) and the backward reads them; the plain route
recomputes them.
(JAX's Pallas pair shifts by the tile's running max and does not mask
dead states; the two agree wherever the cotangent of a dead state is 0,
which is every use in a lattice score.)

``src``, ``dst``, ``w`` and ``em`` are ``[Ba, A]``, each with Ba in
{1, B} independently; a shared input's gradient is summed over the batch;
``em`` may be None (0: the epsilon closure).  An endpoint outside [0, S)
drops its arc (JAX pads with -1).  On CUDA tensors the wrapper launches
the kernels, one a step each way; on CPU tensors it runs their plain
versions.

The forward walks the arcs grouped by destination and the backward by
source, through index tables built once per table on the table's device
(``arc_index``), reading ``w`` and ``em`` at each arc's original id: no
gather into the sorted order, no atomics, so the results are
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
    order of row r (rows: 1 for a shared structure, else B; ``arc`` the
    same in int32); ``dptr`` [rows, S + 1] delimits each destination's
    arcs in that order (arcs without a valid destination come last, past
    ``dptr[:, S]``); ``src`` and ``label`` are the sorted arcs' endpoints
    (-1 where invalid); ``sptr``/``sorder`` and ``lptr``/``lorder`` list
    the sorted positions of each source state and each label; ``sarc``
    and ``sdst`` are the arc and its destination (-1 where invalid) at
    each position of the by-source order ``sorder``."""

    order: torch.Tensor
    dptr: torch.Tensor
    src: torch.Tensor
    sptr: torch.Tensor
    sorder: torch.Tensor
    arc: torch.Tensor
    sarc: torch.Tensor
    sdst: torch.Tensor
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
    dst_s = dst.gather(1, order)
    dst_s = torch.where((dst_s >= 0) & (dst_s < S), dst_s, -1)
    sorder, sptr = _group(src_s, S)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    fields = dict(order=order, dptr=dptr.contiguous(), src=i32(src_s),
                  sptr=sptr.contiguous(), sorder=i32(sorder), arc=i32(order),
                  sarc=i32(order.gather(1, sorder)), sdst=i32(dst_s.gather(1, sorder)))
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


def _check(name, alpha, idx, w, em):
    B, S = alpha.shape
    A = idx.order.shape[1]
    _build.require_cuda(name, alpha, *(x for x in (w, em) if x is not None))
    _build.require(f"{name} alpha", alpha, (B, S), torch.float32)
    if idx.order.shape[0] not in (1, B) or idx.dptr.shape[1] != S + 1:
        raise ValueError(f"{name}: the arc index does not fit alpha {tuple(alpha.shape)}")
    for x in (w, em):
        if x is not None and (x.dtype != torch.float32 or x.dim() != 2
                              or x.shape[1] != A or x.shape[0] not in (1, B)):
            raise ValueError(f"{name}: arc fields must be float32 [1 or {B}, {A}]")
    if B > 65535:
        raise ValueError(f"{name}: a batch of {B} exceeds the grid's 65,535 rows")
    return B, S, A


# The forward copies the vectors it gathers from (alpha, w and em) into
# shared memory where that takes at most 4 loads a thread (1,024 words):
# its passes then wait on two loads from device memory, not three.  On
# larger tables the copy costs more than it saves.
STAGE_WORDS = 1024


def stage_words(S, A, em):
    """Shared-memory words of a staged forward."""
    return S + A * (1 if em is None else 2)


def _per_sample(x, B):
    return int(x is not None and x.shape[0] == B > 1)


def _ptr(x):
    return None if x is None else x.data_ptr()


def seg_lse_fwd_cuda(alpha, w, em, idx, stats=False, staged=None):
    """Launch ``seg_lse_fwd``: alpha [B, S]; w and em (or None) [1 or B, A]
    in the arcs' own order; ``idx`` their ``arc_index`` -> new [B, S], and
    with ``stats`` (new, m, z), each destination's shift and sum, which
    ``seg_lse_bwd_cuda`` reads.  ``staged``: copy alpha, w and em into
    shared memory first (None: where they take at most ``STAGE_WORDS``)."""
    B, S, A = _check("seg_lse_fwd", alpha, idx, w, em)
    _build.require_cuda("seg_lse_fwd", alpha, idx.dptr, idx.src, idx.arc)
    if staged is None:
        staged = stage_words(S, A, em) <= STAGE_WORDS
    elif staged and 4 * stage_words(S, A, em) > _build.MAX_SMEM:
        raise ValueError(f"seg_lse_fwd: S={S} states and A={A} arcs exceed shared memory")
    out = torch.empty_like(alpha)
    m = torch.empty_like(alpha) if stats else None
    z = torch.empty_like(alpha) if stats else None
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(alpha.device):
        err = lib.seg_lse_fwd(
            alpha.data_ptr(), idx.dptr.data_ptr(), idx.src.data_ptr(), idx.arc.data_ptr(),
            w.data_ptr(), _ptr(em), out.data_ptr(), _ptr(m), _ptr(z), B, S, A,
            int(idx.batched), _per_sample(w, B), _per_sample(em, B), int(staged),
            _build.stream_handle(alpha),
        )
    _build.check(lib, err, "seg_lse_fwd")
    _build.LAUNCHES["seg_lse_fwd"] += 1
    return (out, m, z) if stats else out


def seg_lse_bwd_cuda(alpha, w, em, idx, m, z, g, need_dcontrib=True):
    """Launch ``seg_lse_bwd`` with the forward's saved ``m``, ``z`` and the
    cotangent ``g`` [B, S] of its output -> (dalpha [B, S], dcontrib [B, A]
    in the arcs' own order, or None without ``need_dcontrib``)."""
    B, S, A = _check("seg_lse_bwd", alpha, idx, w, em)
    _build.require_cuda("seg_lse_bwd", alpha, g, m, z, idx.sptr, idx.sarc, idx.sdst)
    for name, x in (("g", g), ("m", m), ("z", z)):
        _build.require(f"seg_lse_bwd {name}", x, (B, S), torch.float32)
    dalpha = torch.empty_like(alpha)
    dcontrib = (torch.empty((B, A), dtype=torch.float32, device=alpha.device)
                if need_dcontrib else None)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(alpha.device):
        err = lib.seg_lse_bwd(
            alpha.data_ptr(), g.data_ptr(), m.data_ptr(), z.data_ptr(),
            idx.sptr.data_ptr(), idx.sarc.data_ptr(), idx.sdst.data_ptr(), w.data_ptr(),
            _ptr(em), dalpha.data_ptr(), _ptr(dcontrib), B, S, A, int(idx.batched),
            _per_sample(w, B), _per_sample(em, B), _build.stream_handle(alpha),
        )
    _build.check(lib, err, "seg_lse_bwd")
    _build.LAUNCHES["seg_lse_bwd"] += 1
    return dalpha, dcontrib


class _SegLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, w, em, src, dst, idx):
        alpha = alpha.to(torch.float32).contiguous()
        w = w.to(torch.float32).contiguous()
        em = None if em is None else em.to(torch.float32).contiguous()
        if _build.on_cuda(alpha):
            if idx is None:
                idx = arc_index(src, dst, alpha.shape[1])
            if any(ctx.needs_input_grad[:3]):
                out, m, z = seg_lse_fwd_cuda(alpha, w, em, idx, stats=True)
            else:
                out, m, z = seg_lse_fwd_cuda(alpha, w, em, idx), None, None
            ctx.save_for_backward(alpha, w, em, m, z)
        else:
            out = seg_lse_fwd_plain(alpha, src, dst, w, 0.0 if em is None else em)
            ctx.save_for_backward(alpha, w, em, src, dst)
        ctx.idx = idx
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32).contiguous()
        need_dw, need_dem = ctx.needs_input_grad[1:3]
        if _build.on_cuda(g):
            alpha, w, em, m, z = ctx.saved_tensors
            dalpha, dc = seg_lse_bwd_cuda(alpha, w, em, ctx.idx, m, z, g,
                                          need_dcontrib=need_dw or need_dem)
        else:
            alpha, w, em, src, dst = ctx.saved_tensors
            dalpha, dc = seg_lse_bwd_plain(alpha, src, dst, w, 0.0 if em is None else em, g)
        dw = sum_to(dc, w.shape[0]) if need_dw else None
        dem = sum_to(dc, em.shape[0]) if need_dem else None
        return dalpha, dw, dem, None, None, None


def seg_lse(alpha, src, dst, w, em=None, idx=None):
    """alpha [B, S]; src/dst/w/em [Ba, A], each with Ba in {1, B}
    independently (em None: 0) -> new [B, S].  Differentiable in alpha, w
    and em.  ``idx`` is ``arc_index(src, dst, S)`` where the caller already
    has it (CUDA only)."""
    as2d = lambda x: x if x is None or x.dim() == 2 else x[None]  # noqa: E731
    return _SegLse.apply(alpha, as2d(w), as2d(em), as2d(src), as2d(dst), idx)
