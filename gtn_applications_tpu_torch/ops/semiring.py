"""Log-semiring primitives for lattice dynamic programs (PyTorch).

Counterpart of ``gtn_applications_tpu/ops/semiring.py``.  State values live
in fp32 and use the finite sentinel ``NEG`` for log(0), so dead lattice
states never produce NaNs in the forward recursion or its gradient.
Reductions mask entries at or below ``DEAD`` with exact 0 weights and floor
the sum at ``_FLOOR`` before the log, exactly as the JAX package does.
"""

import torch

# Large finite stand-in for log(0).  exp(NEG - finite) == 0 in fp32 and
# NEG + NEG does not overflow to -inf, keeping gradients NaN-free.
NEG = -1e30

# Entries at or below this are semiring zero (masked with exact 0 weights).
DEAD = -1e28

# Sum floor: a NORMAL fp32 number that keeps log() away from 0 when every
# input underflows; log-of-floor only shifts scores already at NEG.
_FLOOR = 1e-30


def _stable_shift(m):
    # Keep the shift finite even when every input is NEG.
    return torch.clamp(m, min=NEG).detach()


def logaddexp(a, b):
    """Numerically stable log(exp(a) + exp(b)) safe at NEG (dead-masked)."""
    m = _stable_shift(torch.maximum(a, b))
    s = torch.where(a > DEAD, torch.exp(a - m), 0.0) + torch.where(
        b > DEAD, torch.exp(b - m), 0.0
    )
    return torch.where(s > 0.0, m + torch.log(torch.clamp(s, min=_FLOOR)), NEG)


def logsumexp_stack(xs):
    """Stable logsumexp over a list of same-shaped tensors (stacked dim 0)."""
    return logsumexp(torch.stack(xs, dim=0), dim=0)


def logsumexp(x, dim=-1, keepdim=False):
    """Stable logsumexp along ``dim``, safe when all entries are NEG."""
    m = _stable_shift(torch.amax(x, dim=dim, keepdim=True))
    s = torch.sum(
        torch.where(x > DEAD, torch.exp(x - m), 0.0), dim=dim, keepdim=True
    )
    out = torch.where(s > 0.0, m + torch.log(torch.clamp(s, min=_FLOOR)), NEG)
    if not keepdim:
        out = out.squeeze(dim)
    return out


def segment_logsumexp(values, segment_ids, num_segments):
    """logsumexp of ``values [..., A]`` grouped by ``segment_ids`` (same
    shape, or broadcast to it; each in [0, num_segments)) ->
    [..., num_segments], each segment shifted by its own (gradient-free)
    max.  An empty or all-dead segment gives NEG."""
    ids = segment_ids.long().expand(values.shape)
    shape = values.shape[:-1] + (num_segments,)
    m = torch.full(shape, NEG, dtype=values.dtype, device=values.device)
    m = _stable_shift(m.scatter_reduce(-1, ids, values.detach(), "amax"))
    shifted = torch.where(values > DEAD, torch.exp(values - m.gather(-1, ids)), 0.0)
    sums = torch.zeros(shape, dtype=values.dtype, device=values.device)
    sums = sums.scatter_add(-1, ids, shifted)
    return torch.where(sums > 0.0, m + torch.log(torch.clamp(sums, min=_FLOOR)), NEG)


def gather_channels(x, idx, batched=True):
    """Channel gather ``x[..., idx]`` through the gather kernel.

    CUDA tensors launch the hand-written kernel (``ops/csrc/gather.cu``);
    CPU tensors take its plain version.  Index -1 gives exact zeros.

    Args:
      x: [B, T, C] (batched=True) or [T, C].
      idx: [B, S] (batched) or [S] int labels into C.
    Returns: [B, T, S] or [T, S].
    """
    from .gathers import gather_channels_kernel

    if batched:
        return gather_channels_kernel(x, idx)
    return gather_channels_kernel(x[None], idx[None])[0]
