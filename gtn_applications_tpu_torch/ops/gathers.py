"""Channel gather ``x[b, t, idx[b, s]]`` and its transpose, as a kernel pair.

Counterpart of ``gtn_applications_tpu/ops/gathers.py`` (``gather_channels_mxu``
and its Pallas kernels ``_gather_fwd_kernel`` / ``_gather_bwd_kernel``).  On
CUDA tensors the forward and backward launch the hand-written kernels of
``csrc/gather.cu``; on CPU tensors they run the plain versions below, which
compute the same function.  Index -1 marks padding and gives exact zeros.

The CTC pair does not gather: its kernels read the log-probabilities by
label (``lattice_pallas``), and its backward ends in ``gather_bwd_cuda``.
The backward kernel sums each channel's states in ascending s from a plan
it builds in shared memory (no atomics: the same bits on every run);
``gather_bwd_plan`` gives its route and tile.
"""

import ctypes

import torch

from . import _build


def gather_channels_plain(x, idx, t0=0, frames=None):
    """out[b, t, s] = x[b, t0 + t, idx[b, s]], 0 where idx is -1, over
    ``frames`` frames from t0 (default: to the end); a view of x's frames,
    no copy of them."""
    if t0 or frames is not None:
        x = x[:, t0:x.shape[1] if frames is None else t0 + frames]
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


# gather_channels_bwd's tile, a warp's lanes, one frame each, and its warps
# a block (csrc/gather.cu kTileFrames, kThreads / 32)
GATHER_BWD_FRAMES = 32
GATHER_BWD_WARPS = 8


def gather_bwd_plan(S, C):
    """(route, frames a tile, rank warps, shared bytes a block) of
    ``gather_channels_bwd`` at S states and C channels (csrc/gather.cu
    ``bwd_plan``).  The plan, in shared memory on every route, holds
    labels, ranks and order of S ints and first of C + 1.  Route "staged":
    beside it a tile of F g rows (F S + 4 floats: a run keeps its global
    offset mod 4) and F dx rows of C | 1 floats, F the most frames up to
    GATHER_BWD_FRAMES that fit in ``_build.MAX_SMEM``; the states ranked by
    as many warps (each a run of 32-state chunks) as the dx tile holds
    counts of C channels, at most the block's GATHER_BWD_WARPS and one a
    chunk.  Route "global" where not one frame fits: F =
    GATHER_BWD_FRAMES, one rank warp, g and dx in global memory.  Raises
    where the plan alone does not fit."""
    plan = (3 * S + C + 1) * 4
    if plan > _build.MAX_SMEM:
        raise ValueError(
            f"gather_bwd builds a plan of {plan} bytes in shared memory at S={S}, "
            f"C={C}; at most {_build.MAX_SMEM} fit"
        )
    cp = C | 1
    fit = (_build.MAX_SMEM - plan - 16) // ((S + cp) * 4)
    if fit < 1:
        return "global", GATHER_BWD_FRAMES, 1, plan
    frames = min(GATHER_BWD_FRAMES, fit)
    warps = min(frames * cp // C if C > 0 else 1, GATHER_BWD_WARPS, -(-S // 32))
    return "staged", frames, max(1, warps), plan + (frames * S + 4 + frames * cp) * 4


def gather_bwd_kernel_plan(S, C):
    """The CUDA library's own ``bwd_plan`` at (S, C), in the form of
    ``gather_bwd_plan`` (a host call; builds the library)."""
    lib = _build.load_library("gather")
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.gather_bwd_layout(ctypes.addressof(out), S, C, None),
                 "gather_bwd_layout")
    return ("staged" if out[0] else "global"), out[1], out[2], out[3]


def launch_probe(device):
    """Launch the empty kernel of ``csrc/gather.cu`` once on ``device``'s
    current stream: its time is the launch floor of every kernel here."""
    lib = _build.load_library("gather")
    with torch.cuda.device(device):
        err = lib.launch_probe(torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "launch_probe")


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
    -> dx [B, T, C], each channel's states summed in ascending s (the same
    bits on every run).  Raises where the plan does not fit in shared
    memory (``gather_bwd_plan``)."""
    _build.require_cuda("gather_bwd", g, idx)
    B, T, S = g.shape
    _build.require("gather_bwd g", g, (B, T, S), torch.float32)
    _build.require("gather_bwd idx", idx, (B, S), torch.int32)
    gather_bwd_plan(S, C)
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
