"""2-D time-depth-separable encoder (PyTorch, channel-first).

Counterpart of ``TDS2d`` / ``TDSBlock2d`` in
``gtn_applications_tpu/models/tds2d.py``.  The JAX modules are
feature-last; here activations are [B, C, H, W] and every view keeps the
reference's channel order: the input is viewed as [B, c_in, H/c_in, W]
with C major, a block's CD channels are C-major/D-minor, and the head
flattens [B, W', C, H'] with C major.  ``lane_pack`` and ``conv_layout``
select TPU lane-packing layouts of the same math in JAX; they are accepted
and the plain convolution runs.  ``dtype`` (``torch.bfloat16``) computes
the convolutions, dense layers and activations in that dtype with fp32
parameters, fp32 instance-norm statistics and fp32 logits, as JAX's
``dtype`` does (``models/tds.py``).  ``TDS2dTransducer`` is TDS2d, the
WFST convolution ``criterions.transducer.ConvTransduce1D`` (or a plain
``nn.Conv1d`` control), a linear layer and a second TDS2d.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .tds import InstanceNorm, conv_as, dense_as, dropout, init_conv, init_linear


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
        init_conv(self.conv, generator)
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)

    def forward(self, x, train=False, generator=None):
        B, CD, H, W = x.shape
        C, D = self.in_channels, self.img_depth
        # [B, C, D, H, W] (C major) -> fold D into the batch for the conv
        y = x.view(B, C, D, H, W).transpose(1, 2).reshape(B * D, C, H, W)
        y = F.relu(conv_as(self.conv, y))
        y = dropout(y, self.dropout, train, generator)
        y = y.view(B, D, C, H, W).transpose(1, 2).reshape(B, CD, H, W)
        x = self.norm1(y + x)

        y = F.relu(dense_as(self.fc1, x))
        y = dropout(y, self.dropout, train, generator)
        y = dense_as(self.fc2, y)
        y = dropout(y, self.dropout, train, generator)
        return self.norm2(y + x)


class TDS2d(nn.Module):
    """TDS2d encoder: [B, H, W] -> [B, W', output_size].

    Parameters are initialised from ``generator`` (Flax's defaults: LeCun
    normal kernels, zero biases, unit norm scales)."""

    def __init__(self, input_size, output_size, depth, tds_groups,
                 kernel_size, dropout, in_channels=1, lane_pack=False,
                 conv_layout="transpose", dtype=None, generator=None):
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
        self.dtype = dtype or torch.float32
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
            init_conv(conv, generator)
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
        init_linear(self.linear, generator)

    @property
    def time_stride(self):
        """Total downsampling along W (frames per output step)."""
        return int(np.prod([g["stride"][1] for g in self.tds_groups]))

    def forward(self, inputs, train=False, generator=None):
        B, H, W = inputs.shape
        c_in = self.in_channels
        x = inputs.view(B, c_in, H // c_in, W).to(self.dtype)
        blocks = iter(self.blocks)
        for conv, norm, n_blocks in zip(self.convs, self.norms, self._group_blocks):
            x = F.relu(conv_as(conv, x))
            x = dropout(x, self.dropout, train, generator)
            x = norm(x)
            for _ in range(n_blocks):
                x = next(blocks)(x, train=train, generator=generator)
        # [B, C, H', W'] -> [B, W', C*H'] (C major)
        B2, C2, H2, W2 = x.shape
        x = x.permute(0, 3, 1, 2).reshape(B2, W2, C2 * H2)
        # logits in the parameters' dtype: fp32 for the lattice criteria
        return self.linear(x.to(self.linear.weight.dtype))


class TDS2dTransducer(nn.Module):
    """TDS2d -> ConvTransduce1D (or a plain Conv1d control) -> Linear ->
    TDS2d, [B, H, W] -> [B, W', output_size].

    ``tokens`` is the path to the wordpiece token list that the convolution
    emits; its lexicon maps each token to its grapheme indices (the sorted
    characters of the list, blank last), which the first TDS2d scores.
    Extra arguments of the WFST layer arrive in ``conv_kwargs``."""

    def __init__(self, input_size, output_size, tokens, kernel_size, stride,
                 tds1, tds2, wfst=True, conv_kwargs=None, generator=None):
        super().__init__()
        with open(tokens, "r") as fid:
            output_tokens = [l.strip() for l in fid]
        input_tokens = sorted(set(t for token in output_tokens for t in token))
        input_tokens = {t: e for e, t in enumerate(input_tokens)}
        lexicon = [tuple(input_tokens[t] for t in token) for token in output_tokens]
        in_token_size = len(input_tokens) + 1
        blank_idx = len(input_tokens)
        self.kernel_size = kernel_size
        self.stride = stride
        self.tds1_groups = tds1["tds_groups"]
        self.tds2_groups = tds2["tds_groups"]
        self.wfst = wfst

        self.tds1 = TDS2d(input_size=input_size, output_size=in_token_size,
                          generator=generator, **tds1)
        stride_h = int(np.prod([g["stride"][0] for g in tds1["tds_groups"]]))
        inner_size = input_size // stride_h
        if wfst:
            from ..criterions.transducer import ConvTransduce1D

            self.conv = ConvTransduce1D(
                lexicon, kernel_size, stride, blank_idx, **(conv_kwargs or {}))
        else:
            self.conv = nn.Conv1d(in_token_size, len(lexicon), kernel_size,
                                  stride=stride, padding=kernel_size // 2)
            init_conv(self.conv, generator)
        in_channels = tds1["tds_groups"][-1]["channels"] * tds1["depth"]
        self.linear = nn.Linear(len(lexicon), in_channels * inner_size)
        init_linear(self.linear, generator)
        self.tds2 = TDS2d(input_size=inner_size, output_size=output_size,
                          generator=generator, **dict(tds2, in_channels=in_channels))

    @property
    def time_stride(self):
        """Total downsampling along W (frames per output step)."""
        s1 = int(np.prod([g["stride"][1] for g in self.tds1_groups]))
        s2 = int(np.prod([g["stride"][1] for g in self.tds2_groups]))
        return s1 * self.stride * s2

    def forward(self, inputs, train=False, generator=None):
        x = self.tds1(inputs, train=train, generator=generator)  # [B, W, C]
        if self.wfst:
            x = self.conv(x)
        else:
            x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        x = self.linear(x)  # [B, W', in_channels * inner_size]
        # the second encoder reads it as an image [B, H, W']
        return self.tds2(x.transpose(1, 2), train=train, generator=generator)
