"""The port's channel gather against the JAX package's MXU gather.

Inputs come from numpy seeds and go through ``gather_channels_mxu`` (its
Pallas kernels in interpret mode off-TPU) and through the port's
``gather_channels_kernel`` (its plain version on CPU tensors).  The gather
is an exact index on both sides, so the forward matches to rtol 1e-6 (the
tolerance of the JAX package's own tiled-gather test).  The VJP sums the
cotangents of duplicate columns in another order; the cotangent rows are
non-negative and sum to 1 over the columns, as CTC posterior gradients do,
so the sums stay below 1 and match to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops.gathers import gather_channels_mxu
from gtn_applications_tpu_torch.ops import gathers, semiring


def _inputs(B, T, C, S, seed, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    # duplicates are the normal case: idx draws from C with replacement,
    # and a fraction of the columns is -1 padding
    idx = rng.integers(0, C, (B, S)).astype(np.int32)
    idx[rng.random((B, S)) < pad_frac] = -1
    g = rng.random((B, T, S)).astype(np.float32)
    return x, idx, g / g.sum(-1, keepdims=True)


@pytest.mark.parametrize(
    "shape",
    [(2, 7, 11, 13), (2, 50, 201, 5003)],  # 5003: over one TPU column tile
    ids=["small", "tiled_huge_s"],
)
def test_gather_matches_mxu(shape):
    x, idx, g = _inputs(*shape, seed=sum(shape))
    out_j, vjp = jax.vjp(lambda a: gather_channels_mxu(a, jnp.asarray(idx)),
                         jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    gathers.check_indices(torch.from_numpy(idx), shape[2])
    out_t = gathers.gather_channels_kernel(xt, torch.from_numpy(idx))
    out_t.backward(torch.from_numpy(g))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-6)
    padded = np.broadcast_to(idx[:, None, :] < 0, g.shape)
    assert np.all(out_t.detach().numpy()[padded] == 0.0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=0, atol=1e-6)


def test_gather_unbatched_and_index_check():
    x, idx, _ = _inputs(1, 5, 6, 9, seed=3)
    x0, idx0 = torch.from_numpy(x[0]), torch.from_numpy(idx[0])
    out = semiring.gather_channels(x0, idx0, batched=False)
    ref = gathers.gather_channels_plain(x0[None], idx0[None])[0]
    assert torch.equal(out, ref)
    with pytest.raises(ValueError):
        gathers.check_indices(torch.tensor([[0, 6]]), 6)
    with pytest.raises(ValueError):
        gathers.check_indices(torch.tensor([[-2, 0]]), 6)
