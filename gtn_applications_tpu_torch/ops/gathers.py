"""Channel gather ``x[b, t, idx[b, s]]`` and its transpose, as a kernel pair.

Counterpart of ``gtn_applications_tpu/ops/gathers.py`` (``gather_channels_mxu``
and its Pallas kernels ``_gather_fwd_kernel`` / ``_gather_bwd_kernel``).  On
CUDA tensors the forward and backward launch the hand-written kernels of
``csrc/gather.cu``; on CPU tensors they run the plain versions below, which
compute the same function.  Index -1 marks padding and gives exact zeros.
"""

import torch

from . import _build


def gather_channels_plain(x, idx):
    """out[b, t, s] = x[b, t, idx[b, s]], 0 where idx is -1."""
    B, T, _ = x.shape
    idx = idx.long()
    valid = (idx >= 0)[:, None, :]
    full = idx.clamp(min=0)[:, None, :].expand(B, T, idx.shape[1])
    return torch.where(valid, torch.gather(x, 2, full), 0.0)


def gather_channels_bwd_plain(g, idx, C):
    """dx[b, t, c] = sum of g[b, t, s] over s with idx[b, s] == c."""
    B, T, S = g.shape
    idx = idx.long()
    valid = (idx >= 0)[:, None, :]
    full = idx.clamp(min=0)[:, None, :].expand(B, T, S)
    dx = torch.zeros((B, T, C), dtype=g.dtype, device=g.device)
    return dx.scatter_add_(2, full, torch.where(valid, g, 0.0))


def check_indices(idx, C):
    """Raise unless every index is -1 or in [0, C).  Reads the indices back
    to the host, so it is a debugging aid, not part of the hot path."""
    bad = (idx < -1) | (idx >= C)
    if bool(bad.any()):
        raise ValueError(f"gather indices must be -1 or in [0, {C})")


def _int32(idx):
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather indices must be int32 or int64, not {idx.dtype}")
    return idx.to(torch.int32).contiguous()


def gather_fwd_cuda(x, idx):
    """Launch ``gather_channels_fwd``: x [B, T, C] f32, idx [B, S] int32."""
    _build.require_cuda("gather_fwd", x, idx)
    B, T, C = x.shape
    S = idx.shape[-1]
    _build.require("gather_fwd x", x, (B, T, C), torch.float32)
    _build.require("gather_fwd idx", idx, (B, S), torch.int32)
    out = torch.empty((B, T, S), dtype=torch.float32, device=x.device)
    lib = _build.load_library("gather")
    with torch.cuda.device(x.device):
        err = lib.gather_channels_fwd(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, T, C, S,
            _build.stream_handle(x),
        )
    _build.check(lib, err, "gather_channels_fwd")
    _build.LAUNCHES["gather_fwd"] += 1
    return out


def gather_bwd_cuda(g, idx, C):
    """Launch ``gather_channels_bwd``: g [B, T, S] f32, idx [B, S] int32
    -> dx [B, T, C]."""
    _build.require_cuda("gather_bwd", g, idx)
    B, T, S = g.shape
    _build.require("gather_bwd g", g, (B, T, S), torch.float32)
    _build.require("gather_bwd idx", idx, (B, S), torch.int32)
    if C * 4 > _build.MAX_SMEM:
        raise ValueError(
            f"gather_bwd accumulates a row of C={C} floats in shared memory; "
            f"at most {_build.MAX_SMEM // 4} channels fit"
        )
    dx = torch.empty((B, T, C), dtype=torch.float32, device=g.device)
    lib = _build.load_library("gather")
    with torch.cuda.device(g.device):
        err = lib.gather_channels_bwd(
            g.data_ptr(), idx.data_ptr(), dx.data_ptr(), B, T, C, S,
            _build.stream_handle(g),
        )
    _build.check(lib, err, "gather_channels_bwd")
    _build.LAUNCHES["gather_bwd"] += 1
    return dx


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.C = x.shape[-1]
        if _build.on_cuda(x):
            return gather_fwd_cuda(x.contiguous(), _int32(idx))
        return gather_channels_plain(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if _build.on_cuda(g):
            return gather_bwd_cuda(g.contiguous(), _int32(idx), ctx.C), None
        return gather_channels_bwd_plain(g, idx, ctx.C), None


def gather_channels_kernel(x, idx):
    """x: [B, T, C], idx: [B, S] -> [B, T, S], out[b,t,s] = x[b,t,idx[b,s]].

    Differentiable in ``x``.  The kernels treat any index outside [0, C)
    as padding; ``check_indices`` validates indices on request."""
    return _GatherChannels.apply(x, idx)
