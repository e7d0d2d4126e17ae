"""Load a Flax ``TDS2d``, ``TDS`` or ``RNN`` parameter tree into the
port's module, and JAX criterion parameters into the port's criterion.

The tree is the one the JAX package's ``init`` returns, as nested dicts of
numpy arrays (with or without the outer ``"params"`` key).  Flax names a
TDS encoder's modules ``Conv_i`` / ``InstanceNorm_i`` (one per group),
``TDSBlock2d_j`` or ``TDSBlock_j`` (numbered across groups) and
``Dense_0`` (the head); a block holds ``Conv_0``, ``InstanceNorm_0``,
``Dense_0``, ``Dense_1`` and ``InstanceNorm_1``.  An RNN's are ``Conv_i``,
its cells ``<Cell>_k`` (k = 2 layer + direction when bidirectional, else
the layer) and ``Dense_0``.  Layouts:

  * conv kernel (kh, kw, Cin, Cout)     -> (Cout, Cin, kh, kw)
  * TDS2d block conv (kh, kw, 1, C, C)  -> squeeze depth, then as above
  * TDS conv (k, Cin, Cout)             -> (Cout, Cin, k)
  * TDS block conv (k, 1, C, C) over (W, H) -> (C, C, 1, k) over (H, W)
  * Dense kernel (in, out)              -> Linear weight (out, in)
  * cell gates' Dense kernels (in, H)   -> rows of torch's stacked
    weight_ih / weight_hh (gates i, f, g, o or r, z, n), their biases
    rows of bias_ih / bias_hh (a gate's missing bias is 0)
"""

import numpy as np
import torch


def _copy(param, value):
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(
            f"shape mismatch: {tuple(value.shape)} vs {tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(value)


def _conv(conv, p):
    kernel = np.asarray(p["kernel"])
    if kernel.ndim == 5:  # (kh, kw, 1, C, C): the block's depth-shared conv
        kernel = kernel[:, :, 0]
    _copy(conv.weight, kernel.transpose(3, 2, 0, 1))
    _copy(conv.bias, p["bias"])


def _dense(linear, p):
    _copy(linear.weight, np.asarray(p["kernel"]).T)
    _copy(linear.bias, p["bias"])


def _norm(norm, p):
    _copy(norm.scale, p["scale"])
    _copy(norm.bias, p["bias"])


def tds2d_from_flax(params, model):
    """Copy Flax TDS2d ``params`` into the port's ``model`` in place and
    return the model."""
    p = params.get("params", params)
    for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
        _conv(conv, p[f"Conv_{i}"])
        _norm(norm, p[f"InstanceNorm_{i}"])
    for j, block in enumerate(model.blocks):
        bp = p[f"TDSBlock2d_{j}"]
        _conv(block.conv, bp["Conv_0"])
        _norm(block.norm1, bp["InstanceNorm_0"])
        _dense(block.fc1, bp["Dense_0"])
        _dense(block.fc2, bp["Dense_1"])
        _norm(block.norm2, bp["InstanceNorm_1"])
    _dense(model.linear, p["Dense_0"])
    return model


def tds_from_flax(params, model):
    """Copy Flax TDS ``params`` into the port's ``model`` in place and
    return the model."""
    p = params.get("params", params)
    for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
        _copy(conv.weight, np.asarray(p[f"Conv_{i}"]["kernel"]).transpose(2, 1, 0))
        _copy(conv.bias, p[f"Conv_{i}"]["bias"])
        _norm(norm, p[f"InstanceNorm_{i}"])
    for j, block in enumerate(model.blocks):
        bp = p[f"TDSBlock_{j}"]
        _copy(block.conv.weight, np.asarray(bp["Conv_0"]["kernel"]).transpose(3, 2, 1, 0))
        _copy(block.conv.bias, bp["Conv_0"]["bias"])
        _norm(block.norm1, bp["InstanceNorm_0"])
        _dense(block.fc1, bp["Dense_0"])
        _dense(block.fc2, bp["Dense_1"])
        _norm(block.norm2, bp["InstanceNorm_1"])
    _dense(model.linear, p["Dense_0"])
    return model


# Flax's cell class and gate names, in torch's stacked order
_FLAX_CELLS = {
    "LSTM": ("OptimizedLSTMCell", "ifgo"),
    "GRU": ("GRUCell", "rzn"),
    "RNN": ("SimpleCell", ("",)),
}


def rnn_from_flax(params, model, cell_type):
    """Copy Flax RNN ``params`` (cell ``cell_type``: LSTM, GRU or RNN) into
    the port's ``model`` in place and return the model."""
    p = params.get("params", params)
    for i, conv in enumerate(model.convs):
        _conv(conv, p[f"Conv_{i}"])
    name, gates = _FLAX_CELLS[cell_type.upper()]
    k = 0
    for layer in model.layers:
        for suffix in ("", "_reverse")[: 1 + layer.bidirectional]:
            cp = p[f"{name}_{k}"]
            k += 1
            w_ih, w_hh, b_ih, b_hh = [], [], [], []
            for gate in gates:
                i_p, h_p = cp[f"i{gate}"], cp[f"h{gate}"]
                w_ih.append(np.asarray(i_p["kernel"]).T)
                w_hh.append(np.asarray(h_p["kernel"]).T)
                size = w_hh[-1].shape[0]
                b_ih.append(np.asarray(i_p.get("bias", np.zeros(size, np.float32))))
                b_hh.append(np.asarray(h_p.get("bias", np.zeros(size, np.float32))))
            _copy(getattr(layer, f"weight_ih_l0{suffix}"), np.concatenate(w_ih))
            _copy(getattr(layer, f"weight_hh_l0{suffix}"), np.concatenate(w_hh))
            _copy(getattr(layer, f"bias_ih_l0{suffix}"), np.concatenate(b_ih))
            _copy(getattr(layer, f"bias_hh_l0{suffix}"), np.concatenate(b_hh))
    _dense(model.linear, p["Dense_0"])
    return model


def criterion_params_from_jax(params, device=None):
    """JAX's ``params["criterion"]`` (a dict of numpy arrays: ASG's and the
    Transducer's ``transitions``, one weight per arc of its n-gram or loaded
    transition graph in the graph's arc order on both sides; ``{}`` for
    CTC, STC and the transitions-free Transducer) as the port's
    ``criterion.params`` on ``device``, each a leaf that requires grad."""
    return {
        name: torch.from_numpy(np.array(value, dtype=np.float32))
        .to(device).requires_grad_(True)
        for name, value in params.items()
    }
