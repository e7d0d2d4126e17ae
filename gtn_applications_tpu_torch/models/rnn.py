"""Convolutional front end and recurrent encoder.

Counterpart of ``RNN`` in ``gtn_applications_tpu/models/rnn.py``: strided
2-D convolutions over the [B, H, W] image, the [B, W', C*H'] flatten with C
major, a stack of (optionally bidirectional) LSTM, GRU or plain tanh RNN
layers over time with dropout between them, and a dense head.  The layers
are ``nn.LSTM`` / ``nn.GRU`` / ``nn.RNN`` (cuDNN on the card), one module a
layer so that the dropout between layers draws its masks from the caller's
generator.  As in JAX, every padded frame is fed to the recurrence (no
packed sequences): the reverse direction starts in the padding.

Flax's cells hold their gates as separate dense layers; ``rnn_from_flax``
(``models/convert.py``) maps them into torch's stacked weights, gate order
i, f, g, o (LSTM) and r, z, n (GRU).  Flax's input projections of the LSTM,
and its hidden projections but hn of the GRU and of the plain cell, carry
no bias: their torch biases are 0 there.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .tds import dropout, init_conv, init_linear, lecun_normal_

_CELLS = {"LSTM": (nn.LSTM, 4), "GRU": (nn.GRU, 3), "RNN": (nn.RNN, 1)}


def _init_recurrent(layer, gates, generator):
    """Flax's cell defaults: LeCun normal input kernels, orthogonal
    recurrent kernels, a gate at a time; zero biases."""
    for name, w in layer.named_parameters():
        with torch.no_grad():
            if name.startswith("bias"):
                nn.init.zeros_(w)
                continue
            for chunk in w.chunk(gates, dim=0):
                if name.startswith("weight_ih"):
                    lecun_normal_(chunk, chunk.shape[1], generator)
                else:
                    nn.init.orthogonal_(chunk, generator=generator)


class RNN(nn.Module):
    """Conv front end + recurrent layers + dense head: [B, H, W] ->
    [B, W', output_size].  Parameters are initialised from ``generator``."""

    def __init__(self, input_size, output_size, cell_type, hidden_size,
                 num_layers, dropout=0.0, bidirectional=False, channels=(8, 8),
                 kernel_sizes=((5, 5), (5, 5)), strides=((2, 2), (2, 2)),
                 generator=None):
        super().__init__()
        cell = cell_type.upper()
        if cell not in _CELLS:
            raise ValueError(f"Unknown rnn cell type {cell_type}")
        self.dropout = dropout
        self.strides = [tuple(s) for s in strides]
        self.convs = nn.ModuleList()
        c_in, h_out = 1, input_size
        for c_out, (kh, kw), stride in zip(channels, kernel_sizes, self.strides):
            conv = nn.Conv2d(c_in, c_out, (kh, kw), stride=stride,
                             padding=(kh // 2, kw // 2))
            init_conv(conv, generator)
            self.convs.append(conv)
            h_out = (h_out + 2 * (kh // 2) - kh) // stride[0] + 1
            c_in = c_out
        rnn_cls, gates = _CELLS[cell]
        self.layers = nn.ModuleList()
        size = c_in * h_out
        for _ in range(num_layers):
            layer = rnn_cls(size, hidden_size, batch_first=True,
                            bidirectional=bidirectional)
            _init_recurrent(layer, gates, generator)
            self.layers.append(layer)
            size = hidden_size * (2 if bidirectional else 1)
        self.linear = nn.Linear(size, output_size)
        init_linear(self.linear, generator)

    @property
    def time_stride(self):
        """Total downsampling along W (frames per output step)."""
        out = 1
        for s in self.strides:
            out *= s[1]
        return out

    def forward(self, inputs, train=False, generator=None):
        x = inputs[:, None]  # [B, 1, H, W]
        for conv in self.convs:
            x = dropout(F.relu(conv(x)), self.dropout, train, generator)
        # [B, C, H', W'] -> [B, W', C*H'] (C major)
        B, C, H, W = x.shape
        x = x.permute(0, 3, 1, 2).reshape(B, W, C * H)
        for i, layer in enumerate(self.layers):
            x = layer(x)[0]
            if i < len(self.layers) - 1:
                x = dropout(x, self.dropout, train, generator)
        return self.linear(x)
