"""Load a Flax ``TDS2d`` parameter tree into the port's module, and JAX
criterion parameters into the port's criterion.

The tree is the one the JAX package's ``TDS2d.init`` returns, as
nested dicts of numpy arrays (with or without the outer ``"params"`` key).
Flax names the modules ``Conv_i`` / ``InstanceNorm_i`` (one per group),
``TDSBlock2d_j`` (numbered across groups) and ``Dense_0`` (the head); a
block holds ``Conv_0``, ``InstanceNorm_0``, ``Dense_0``, ``Dense_1`` and
``InstanceNorm_1``.  Layouts:

  * conv kernel (kh, kw, Cin, Cout)     -> (Cout, Cin, kh, kw)
  * block conv  (kh, kw, 1, C, C)       -> squeeze depth, then as above
  * Dense kernel (in, out)              -> Linear weight (out, in)
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
