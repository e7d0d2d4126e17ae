"""Time-depth-separable 1-D encoder, and the instance norm, initialisers
and compute-dtype helpers shared by the TDS encoders.

Counterpart of ``InstanceNorm``, ``TDSBlock`` and ``TDS`` in
``gtn_applications_tpu/models/tds.py``.  The JAX modules are feature-last
([B, W, C*H]); here activations are channel-first [B, C*H, W], and a
block views its channels as [B, C, H, W] with C major, the reference's
order.  ``dtype`` (``torch.bfloat16``) runs the convolutions, dense layers
and activations in that dtype, as JAX's ``dtype`` does: the parameters
stay fp32 and are cast at each use, the instance norms take their
statistics in fp32, and the head computes fp32 logits.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class InstanceNorm(nn.Module):
    """InstanceNorm with affine params over a channel-first tensor
    [B, C, *spatial]: normalise per sample per channel over the spatial
    dims, no running stats.

    Statistics are taken in fp32 in one pass, E[x^2] - E[x]^2 (clamped at
    0), as the JAX module does, over every spatial position including
    zero-padded width columns; the result has the input's dtype.  With a
    ``seq_group``, ``x`` is this rank's time shard along the last axis:
    the (sum, sum of squares) pair is summed over the group's shards, so
    the statistics are the global width's."""

    def __init__(self, features):
        super().__init__()
        self.features = features
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, seq_group=None):
        dtype = x.dtype
        x32 = x.to(torch.float32)
        dims = tuple(range(2, x.dim()))
        if seq_group is None:
            mean = torch.mean(x32, dim=dims, keepdim=True)
            m2 = torch.mean(x32 * x32, dim=dims, keepdim=True)
        else:
            count = math.prod(x.shape[2:]) * torch.distributed.get_world_size(seq_group)
            sums = torch.stack([torch.sum(x32, dim=dims), torch.sum(x32 * x32, dim=dims)])
            sums = mesh.all_reduce_sum(sums, seq_group) / count
            mean, m2 = (v.view(v.shape + (1,) * len(dims)) for v in sums.unbind(0))
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


def init_conv(conv, generator):
    lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
    nn.init.zeros_(conv.bias)


def init_linear(linear, generator):
    lecun_normal_(linear.weight, linear.in_features, generator)
    nn.init.zeros_(linear.bias)


def dropout(x, p, train, generator=None):
    """Inverted dropout drawing its mask from ``generator``."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def conv_as(conv, x):
    """``conv`` computed in x's dtype, its fp32 parameters cast."""
    if x.dtype == conv.weight.dtype:
        return conv(x)
    return conv._conv_forward(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def dense_as(linear, x, dim=1):
    """``linear`` over dim ``dim`` of x, computed in x's dtype."""
    x = x.movedim(dim, -1)
    if x.dtype == linear.weight.dtype:
        y = linear(x)
    else:
        y = F.linear(x, linear.weight.to(x.dtype), linear.bias.to(x.dtype))
    return y.movedim(-1, dim)


class TDSBlock(nn.Module):
    """TDS block on [B, C*H, W]: a (1, k) conv mapping C -> C shared over
    the H planes, then a two-layer dense over the CH channels, each with a
    residual and an instance norm over time."""

    def __init__(self, in_channels, num_features, kernel_size, dropout,
                 generator=None):
        super().__init__()
        self.in_channels = in_channels
        self.num_features = num_features
        self.dropout = dropout
        C, CH = in_channels, in_channels * num_features
        self.conv = nn.Conv2d(C, C, (1, kernel_size), padding=(0, kernel_size // 2))
        self.norm1 = InstanceNorm(CH)
        self.fc1 = nn.Linear(CH, CH)
        self.fc2 = nn.Linear(CH, CH)
        self.norm2 = InstanceNorm(CH)
        init_conv(self.conv, generator)
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)

    def forward(self, x, train=False, generator=None):
        B, CH, W = x.shape
        y = F.relu(conv_as(self.conv, x.view(B, self.in_channels, self.num_features, W)))
        y = dropout(y, self.dropout, train, generator)
        x = self.norm1(y.reshape(B, CH, W) + x)

        y = F.relu(dense_as(self.fc1, x))
        y = dropout(y, self.dropout, train, generator)
        y = dropout(dense_as(self.fc2, y), self.dropout, train, generator)
        return self.norm2(y + x)


class TDS(nn.Module):
    """TDS encoder: [B, H, W] -> [B, W', output_size], H = input_size.

    Each group is a strided 1-D conv over time to ``input_size *
    channels`` channels (``stride``, default 2), ReLU, dropout and an
    instance norm, then ``num_blocks`` TDS blocks.  Parameters are
    initialised from ``generator`` (Flax's defaults)."""

    def __init__(self, input_size, output_size, tds_groups, kernel_size,
                 dropout, dtype=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.tds_groups = tds_groups
        self.dropout = dropout
        self.dtype = dtype or torch.float32
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self._group_blocks = []
        c_in = input_size
        for group in tds_groups:
            c_out = input_size * group["channels"]
            conv = nn.Conv1d(c_in, c_out, kernel_size, stride=group.get("stride", 2),
                             padding=kernel_size // 2)
            init_conv(conv, generator)
            self.convs.append(conv)
            self.norms.append(InstanceNorm(c_out))
            for _ in range(group["num_blocks"]):
                self.blocks.append(TDSBlock(group["channels"], input_size, kernel_size,
                                            dropout, generator))
            self._group_blocks.append(group["num_blocks"])
            c_in = c_out
        self.linear = nn.Linear(c_in, output_size)
        init_linear(self.linear, generator)

    @property
    def time_stride(self):
        """Total downsampling along W (frames per output step)."""
        out = 1
        for g in self.tds_groups:
            out *= g.get("stride", 2)
        return out

    def forward(self, inputs, train=False, generator=None):
        x = inputs.to(self.dtype)  # [B, H, W]: the features are the channels
        blocks = iter(self.blocks)
        for conv, norm, n_blocks in zip(self.convs, self.norms, self._group_blocks):
            x = dropout(F.relu(conv_as(conv, x)), self.dropout, train, generator)
            x = norm(x)
            for _ in range(n_blocks):
                x = next(blocks)(x, train=train, generator=generator)
        # logits in fp32 for the lattice criteria
        return self.linear(x.transpose(1, 2).to(torch.float32))
