"""The port's CTC lattice against the JAX package and the CTC goldens.

Inputs come from numpy seeds and go through ``lattice.ctc_loss`` of both
packages.  The JAX side runs ``impl="pallas"`` (its Pallas kernels in
interpret mode off-TPU) and ``impl="scan"``; the port runs ``impl="auto"``
(the kernel ``Function`` with its plain versions on CPU tensors) and
``impl="scan"``.  Tolerances: loss atol 1e-4, gradient w.r.t. the logits
atol 1e-5 (fp32 recursions over 16 frames, exp/log taken by two libraries
in another order; the kernel path's t = 0 step differs from the scan's
seeding only by fp32 rounding).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions.common import pad_targets as jax_pad_targets
from gtn_applications_tpu.ops import lattice as jax_lattice
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.criterions.common import pad_targets
from gtn_applications_tpu_torch.ops import lattice

PORT_IMPLS = ["auto", "scan"]


def _port_loss_and_grad(logits, targets_list, blank, impl, input_lengths=None,
                        reduction="mean"):
    x = torch.from_numpy(logits).requires_grad_(True)
    targets, lengths = pad_targets(targets_list)
    lens = None if input_lengths is None else torch.tensor(input_lengths)
    loss = lattice.ctc_loss(
        torch.log_softmax(x, dim=2), targets, lengths, blank, reduction,
        lens, impl,
    )
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("port_impl", PORT_IMPLS)
@pytest.mark.parametrize("jax_impl", ["pallas", "scan"])
def test_ctc_loss_matches_jax(jax_impl, port_impl):
    rng = np.random.RandomState(0)
    B, T, N = 4, 16, 6
    logits = rng.randn(B, T, N).astype(np.float32)
    # repeated labels (disallowed skips), an empty target, ragged lengths
    tgts = [[0, 1, 1, 2], [3], [], [2, 2, 2, 4, 0]]
    input_lengths = [16, 12, 9, 14]

    targets, lengths = jax_pad_targets(tgts)

    def loss_fn(x):
        return jax_lattice.ctc_loss(
            jax.nn.log_softmax(x, axis=2), targets, lengths, N - 1, "mean",
            jnp.asarray(input_lengths), jax_impl,
        )

    loss_j, grad_j = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    loss_t, grad_t = _port_loss_and_grad(logits, tgts, N - 1, port_impl,
                                         input_lengths)
    assert abs(loss_t - float(loss_j)) < 1e-4
    np.testing.assert_allclose(grad_t, np.asarray(grad_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_ctc_golden_table(impl):
    """The classic 5x6 CTC table: loss 3.34211 and its logit gradients."""
    T, N = 5, 6
    emissions = np.array(
        [
            0.633766, 0.221185, 0.0917319, 0.0129757, 0.0142857, 0.0260553,
            0.111121, 0.588392, 0.278779, 0.0055756, 0.00569609, 0.010436,
            0.0357786, 0.633813, 0.321418, 0.00249248, 0.00272882, 0.0037688,
            0.0663296, 0.643849, 0.280111, 0.00283995, 0.0035545, 0.00331533,
            0.458235, 0.396634, 0.123377, 0.00648837, 0.00903441, 0.00623107,
        ],
        dtype=np.float32,
    ).reshape(1, T, N)
    expected_grad = np.array(
        [
            -0.366234, 0.221185, 0.0917319, 0.0129757, 0.0142857, 0.0260553,
            0.111121, -0.411608, 0.278779, 0.0055756, 0.00569609, 0.010436,
            0.0357786, 0.633813, -0.678582, 0.00249248, 0.00272882, 0.0037688,
            0.0663296, -0.356151, 0.280111, 0.00283995, 0.0035545, 0.00331533,
            -0.541765, 0.396634, 0.123377, 0.00648837, 0.00903441, 0.00623107,
        ],
        dtype=np.float32,
    ).reshape(1, T, N)
    loss, grad = _port_loss_and_grad(
        np.log(emissions), [[0, 1, 2, 1, 0]], N - 1, impl, reduction="none"
    )
    assert abs(loss - 3.34211) < 1e-4
    np.testing.assert_allclose(grad, expected_grad, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_ctc_edge_cases(impl):
    rng = np.random.RandomState(1)
    T, N = 10, 5
    x = rng.randn(3, T, N).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(x), dim=2)

    # empty target: the only path is all blanks
    tg, ln = pad_targets([[]])
    empty = lattice.ctc_loss(lp[:1], tg, ln, N - 1, "none", impl=impl)
    assert abs(float(empty) + float(lp[0, :, N - 1].sum())) < 1e-4

    # input_lengths: padded frames past the length are ignored
    tg, ln = pad_targets([[0, 1, 2]])
    a = lattice.ctc_loss(
        torch.log_softmax(torch.from_numpy(x[:1, :7]), 2), tg, ln, N - 1,
        impl=impl,
    )
    b = lattice.ctc_loss(lp[:1], tg, ln, N - 1, input_lengths=torch.tensor([7]),
                         impl=impl)
    assert abs(float(a) - float(b)) < 1e-4

    # batched padded loss == mean of singles
    tgts = [[0, 1, 2], [3, 3], [1, 2, 3, 0, 1]]
    tg, ln = pad_targets(tgts)
    batched = lattice.ctc_loss(lp, tg, ln, N - 1, "mean", impl=impl)
    singles = [
        float(lattice.ctc_loss(lp[i:i + 1], *pad_targets([tgts[i]]), N - 1,
                               "mean", impl=impl))
        for i in range(3)
    ]
    assert abs(float(batched) - np.mean(singles)) < 1e-4


def test_ctc_viterbi_collapse_and_uniform():
    crit = CTC(blank=2)
    outputs = torch.tensor(
        [[[5, 0, 0], [5, 0, 0], [0, 0, 5], [0, 5, 0], [0, 5, 0]]],
        dtype=torch.float32,
    )
    assert crit.viterbi(outputs)[0].tolist() == [0, 1]
    assert crit.viterbi(outputs, input_lengths=torch.tensor([2]))[0].tolist() == [0]

    # uniform emissions: "ab" into 3 frames has 5 alignments
    lp = torch.full((1, 3, 3), math.log(1.0 / 3))
    loss = lattice.ctc_loss(lp, *pad_targets([[0, 1]]), 2, "none")
    assert abs(float(loss) + math.log(5 / 27)) < 1e-4


def test_ctc_unported_forms_raise():
    lp = torch.zeros(1, 4, 3)
    tg, ln = pad_targets([[0]])
    for impl in ("assoc", "chunked"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lattice.ctc_loss(lp, tg, ln, 2, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lattice.ctc_loss(torch.zeros(1, 4097, 3), tg, ln, 2)
    with pytest.raises(ValueError):
        lattice.ctc_loss(lp, tg, ln, 2, impl="pallas")


@pytest.mark.parametrize("config", [{"chunk": 256}, {"use_pt": True}])
def test_ctc_criterion_refuses_unported_options(config):
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.datasets import synthetic

    pre = synthetic.Preprocessor(None, num_features=16)
    crit, _ = utils.load_criterion("ctc", pre, {"impl": "scan"})
    assert crit.impl == "scan"
    with pytest.raises(NotImplementedError):
        utils.load_criterion("ctc", pre, config)
