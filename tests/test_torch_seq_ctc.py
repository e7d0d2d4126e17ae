"""The port's sequence-parallel assoc CTC against JAX's assoc forms.

Two gloo ranks on a ``('data', 'seq')`` grid of 1 x 2 (one spawn; the
workers in ``tests/torch_dist_workers.py`` import no JAX) each hold half
of the frames of [2, 512, 6] log-probabilities and run
``ops.lattice.ctc_forward_score_assoc(..., chunk=128, seq_group=...)``:
each composes its own chunk transfers, the two operators are gathered and
composed in rank order.  The score sum and the gradient to the
log-probabilities (each rank's block of frames) are held to JAX's
``ctc_forward_score_assoc(chunk=128)`` under ``jax.jit``:

  * in float32, at JAX's own assoc tolerances (``tests/test_assoc_scan.py``:
    score rtol 1e-4, gradient rtol 1e-3 / atol 1e-4), and against JAX's
    float64 score and gradient (``jax.enable_x64``): the port's float32
    gradient no farther from it than JAX's float32 one, by the largest and
    the mean error, within 2x (the seq form composes its chunks in
    another order: rank 0's chunks start after frame 0, rank 1's at frame
    256, JAX's run 1-128, 129-256, ...);
  * in float64, with ragged input lengths (a sample ending in rank 1's
    frames, one ending in rank 0's), within rtol 1e-9: the same
    composition to rounding;
  * the per-frame form (no chunk) in float64 at T = 64, within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import lattice as jax_lattice
from gtn_applications_tpu_torch.parallel import mesh as pmesh

from tests import torch_dist_workers as workers

N = 2
B, T, C, L, CHUNK = 2, 512, 6, 4, 128
F32_SCORE = dict(rtol=1e-4)
F32_GRAD = dict(rtol=1e-3, atol=1e-4)
F64 = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores, and a CPU train loop with a thread per core each slows ~70x
    under that contention (as in ``tests/test_torch_ctc_long.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, t, dtype, input_lengths=None, chunk=CHUNK):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, t, C)
    lp = (x - np.log(np.exp(x).sum(2, keepdims=True))).astype(dtype)
    targets = rng.randint(0, C - 1, size=(B, L))
    lens = np.full((B,), L)
    return lp, targets, lens, input_lengths, chunk


CASES = [
    _case(0, T, np.float32),
    _case(1, T, np.float64, np.array([400, 200])),
    _case(2, 64, np.float64, None, None),
]


def _jax(case, x64):
    lp, targets, lens, il, chunk = case
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32

        @jax.jit
        def f(lp):
            return jax.value_and_grad(lambda lp: jax_lattice.ctc_forward_score_assoc(
                lp, jnp.asarray(targets), jnp.asarray(lens), C - 1,
                None if il is None else jnp.asarray(il), chunk=chunk).sum())(lp)

        val, grad = f(jnp.asarray(lp, dtype))
        return float(val), np.asarray(grad)


@pytest.fixture(scope="module")
def ranks():
    results = pmesh.spawn(workers.seq_ctc, N, args=(CASES,), timeout=300)
    out = []
    for i in range(len(CASES)):
        scores = [r[i][0] for r in results]
        assert scores[0] == scores[1]  # every rank of the group scores alike
        out.append((scores[0], np.concatenate([r[i][1] for r in results], axis=1)))
    return out


def test_seq_ctc_float32_matches_jax(ranks):
    score, grad = ranks[0]
    want, want_grad = _jax(CASES[0], False)
    np.testing.assert_allclose(score, want, **F32_SCORE)
    np.testing.assert_allclose(grad, want_grad, **F32_GRAD)
    exact, exact_grad = _jax(CASES[0], True)
    port_err, jax_err = np.abs(grad - exact_grad), np.abs(want_grad - exact_grad)
    assert port_err.max() <= 2 * jax_err.max(), (port_err.max(), jax_err.max())
    assert port_err.mean() <= 2 * jax_err.mean(), (port_err.mean(), jax_err.mean())
    assert abs(score - exact) <= 2 * max(abs(want - exact), 1e-6 * abs(exact))


@pytest.mark.parametrize("i", [1, 2])
def test_seq_ctc_float64_matches_jax(ranks, i):
    score, grad = ranks[i]
    want, want_grad = _jax(CASES[i], True)
    np.testing.assert_allclose(score, want, **F64)
    np.testing.assert_allclose(grad, want_grad, **F64)
