"""2-D time-depth-separable encoder (PyTorch, channel-first).

Counterpart of ``TDS2d`` / ``TDSBlock2d`` in
``gtn_applications_tpu/models/tds2d.py``.  The JAX modules are
feature-last; here activations are [B, C, H, W] and every view keeps the
reference's channel order: the input is viewed as [B, c_in, H/c_in, W]
with C major, a block's CD channels are C-major/D-minor, and the head
flattens [B, W', C, H'] with C major.  ``lane_pack`` and ``conv_layout``
select TPU lane-packing layouts of the same math in JAX; they are accepted
and the plain convolution runs.  ``TDS2dTransducer`` is not ported yet
(ROADMAP queue A item 9).
"""

import numpy as np
import torch.nn.functional as F
from torch import nn

from .tds import InstanceNorm, dropout, lecun_normal_


def _init_conv(conv, generator):
    kh, kw = conv.kernel_size
    lecun_normal_(conv.weight, kh * kw * conv.in_channels, generator)
    nn.init.zeros_(conv.bias)


def _init_linear(linear, generator):
    lecun_normal_(linear.weight, linear.in_features, generator)
    nn.init.zeros_(linear.bias)


def _dense(linear, x):
    """A Dense layer over the channel dim of [B, C, H, W]."""
    return linear(x.movedim(1, -1)).movedim(-1, 1)


class TDSBlock2d(nn.Module):
    """2-D TDS block on [B, C*D, H, W]: a (kh, kw) conv mapping C -> C shared
    over the D depth planes, then a two-layer dense over the CD channels,
    each with a residual and an instance norm."""

    def __init__(self, in_channels, img_depth, kernel_size, dropout,
                 lane_pack=False, conv_layout="transpose", generator=None):
        super().__init__()
        if conv_layout not in ("transpose", "dimnums"):
            raise ValueError(f"unknown conv_layout {conv_layout!r}")
        self.in_channels = in_channels
        self.img_depth = img_depth
        self.dropout = dropout
        kh, kw = kernel_size
        C, CD = in_channels, in_channels * img_depth
        self.conv = nn.Conv2d(C, C, (kh, kw), padding=(kh // 2, kw // 2))
        self.norm1 = InstanceNorm(CD)
        self.fc1 = nn.Linear(CD, CD)
        self.fc2 = nn.Linear(CD, CD)
        self.norm2 = InstanceNorm(CD)
        _init_conv(self.conv, generator)
        _init_linear(self.fc1, generator)
        _init_linear(self.fc2, generator)

    def forward(self, x, train=False, generator=None):
        B, CD, H, W = x.shape
        C, D = self.in_channels, self.img_depth
        # [B, C, D, H, W] (C major) -> fold D into the batch for the conv
        y = x.view(B, C, D, H, W).transpose(1, 2).reshape(B * D, C, H, W)
        y = F.relu(self.conv(y))
        y = dropout(y, self.dropout, train, generator)
        y = y.view(B, D, C, H, W).transpose(1, 2).reshape(B, CD, H, W)
        x = self.norm1(y + x)

        y = F.relu(_dense(self.fc1, x))
        y = dropout(y, self.dropout, train, generator)
        y = _dense(self.fc2, y)
        y = dropout(y, self.dropout, train, generator)
        return self.norm2(y + x)


class TDS2d(nn.Module):
    """TDS2d encoder: [B, H, W] -> [B, W', output_size].

    Parameters are initialised from ``generator`` (Flax's defaults: LeCun
    normal kernels, zero biases, unit norm scales)."""

    def __init__(self, input_size, output_size, depth, tds_groups,
                 kernel_size, dropout, in_channels=1, lane_pack=False,
                 conv_layout="transpose", generator=None):
        super().__init__()
        stride_h = int(np.prod([g["stride"][0] for g in tds_groups]))
        if input_size % stride_h != 0:
            raise ValueError(
                f"Image height not divisible by total stride {stride_h}."
            )
        self.input_size = input_size
        self.output_size = output_size
        self.depth = depth
        self.tds_groups = tds_groups
        self.in_channels = in_channels
        self.dropout = dropout
        kh, kw = kernel_size
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self._group_blocks = []
        c_in = in_channels
        for group in tds_groups:
            c_out = depth * group["channels"]
            conv = nn.Conv2d(
                c_in, c_out, (kh, kw), stride=tuple(group["stride"]),
                padding=(kh // 2, kw // 2),
            )
            _init_conv(conv, generator)
            self.convs.append(conv)
            self.norms.append(InstanceNorm(c_out))
            for _ in range(group["num_blocks"]):
                self.blocks.append(TDSBlock2d(
                    group["channels"], depth, kernel_size, dropout,
                    lane_pack, conv_layout, generator,
                ))
            self._group_blocks.append(group["num_blocks"])
            c_in = c_out
        h_out = input_size // stride_h
        self.linear = nn.Linear(c_in * h_out, output_size)
        _init_linear(self.linear, generator)

    @property
    def time_stride(self):
        """Total downsampling along W (frames per output step)."""
        return int(np.prod([g["stride"][1] for g in self.tds_groups]))

    def forward(self, inputs, train=False, generator=None):
        B, H, W = inputs.shape
        c_in = self.in_channels
        x = inputs.view(B, c_in, H // c_in, W)
        blocks = iter(self.blocks)
        for conv, norm, n_blocks in zip(self.convs, self.norms, self._group_blocks):
            x = F.relu(conv(x))
            x = dropout(x, self.dropout, train, generator)
            x = norm(x)
            for _ in range(n_blocks):
                x = next(blocks)(x, train=train, generator=generator)
        # [B, C, H', W'] -> [B, W', C*H'] (C major)
        B2, C2, H2, W2 = x.shape
        x = x.permute(0, 3, 1, 2).reshape(B2, W2, C2 * H2)
        return self.linear(x)
