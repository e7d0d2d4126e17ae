"""Instance normalisation and initialisers shared by the TDS encoders.

Counterpart of ``InstanceNorm`` in ``gtn_applications_tpu/models/tds.py``.
The 1-D ``TDS`` encoder is not ported yet (ROADMAP queue A item 10).
"""

import math

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """InstanceNorm with affine params over a channel-first tensor
    [B, C, *spatial]: normalise per sample per channel over the spatial
    dims, no running stats.

    Statistics are taken in fp32 in one pass, E[x^2] - E[x]^2 (clamped at
    0), as the JAX module does, over every spatial position including
    zero-padded width columns."""

    def __init__(self, features):
        super().__init__()
        self.features = features
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dtype = x.dtype
        x32 = x.to(torch.float32)
        dims = tuple(range(2, x.dim()))
        mean = torch.mean(x32, dim=dims, keepdim=True)
        m2 = torch.mean(x32 * x32, dim=dims, keepdim=True)
        var = torch.clamp(m2 - mean * mean, min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        shape = (1, self.features) + (1,) * len(dims)
        return (y * self.scale.view(shape) + self.bias.view(shape)).to(dtype)


def lecun_normal_(weight, fan_in, generator=None):
    """Flax's default kernel init: a normal truncated at two standard
    deviations, rescaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def dropout(x, p, train, generator=None):
    """Inverted dropout drawing its mask from ``generator``."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)
