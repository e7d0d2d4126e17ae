"""The port's TDS2d encoder against the Flax module on the same weights.

``TDS2d.init`` of the JAX package draws the parameters; ``tds2d_from_flax``
loads them into the port, and both run the same numpy input in eval mode
with dropout 0.  The encoder is fp32 convolutions, one-pass instance norms
and dense layers computed by two libraries in another order, so the outputs
match to atol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from gtn_applications_tpu.models import InstanceNorm as FlaxInstanceNorm
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu_torch.models import InstanceNorm, TDS2d
from gtn_applications_tpu_torch.models.convert import tds2d_from_flax

# the widths of configs/synthetic/tds2d_ctc.json
SYNTHETIC = dict(
    depth=2,
    tds_groups=[
        {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
        {"channels": 8, "num_blocks": 1, "stride": [2, 1]},
    ],
    kernel_size=(3, 5),
    dropout=0.0,
)


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("width", [32, 37])  # even and odd input widths
def test_tds2d_matches_flax(width):
    rng = np.random.RandomState(width)
    x = rng.rand(3, 16, width).astype(np.float32)
    x[2, :, width - 9:] = 0.0  # zero-padded columns count in the norms
    flax_model = FlaxTDS2d(input_size=16, output_size=12, **SYNTHETIC)
    variables = flax_model.init(jax.random.PRNGKey(width), x)
    ref = np.asarray(flax_model.apply(variables, x))

    model = TDS2d(input_size=16, output_size=12, **SYNTHETIC)
    tds2d_from_flax(_as_numpy(variables), model)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, -(-width // 2), 12)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_instance_norm_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 7, 6) * 3 + 1).astype(np.float32)  # [B, H, W, C]
    norm = FlaxInstanceNorm(features=6, axes=(1, 2))
    variables = norm.init(jax.random.PRNGKey(0), x)
    scale = rng.randn(6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}}
    ref = np.asarray(norm.apply(variables, x))

    port = InstanceNorm(6)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
