"""The port's WFST convolution (``ops/convkernel.py``, ``ConvTransduce1D``
and ``make_kernel_graph`` in ``criterions/transducer.py``) against the JAX
package's, on inputs made with numpy from a seed.

Tolerances: the tables and kernel graphs are equal exactly; scores within
rtol 1e-5 (atol 1e-6); gradients entry by entry within 1e-5 + 1e-4 |g| of
JAX's, the input's and the learned arc weights', in the log and Viterbi
modes, under every scale and normalisation, by the direct route and the
V-chunked one (its threshold lowered on both sides).  JAX runs under
``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import transducer as jtrans
from gtn_applications_tpu.ops import convkernel as jck
from gtn_applications_tpu_torch.criterions.transducer import (
    ConvTransduce1D, make_kernel_graph,
)
from gtn_applications_tpu_torch.ops import convkernel
from gtn_applications_tpu_torch.wfst import Graph, ops

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _lexicon(rng, V, C, max_len=3):
    return [tuple(int(c) for c in rng.randint(0, C, rng.randint(1, max_len + 1)))
            for _ in range(V)]


@pytest.mark.parametrize("blank_optional", [True, False])
@pytest.mark.parametrize("spike", [False, True])
def test_tables_and_kernel_graphs_match_jax(blank_optional, spike):
    rng = np.random.RandomState(0)
    lexicon = _lexicon(rng, 12, 3) + [(1, 1, 1), (0,)]
    tables = convkernel.compile_kernels(lexicon, 3, blank_optional, spike)
    ref = jck.compile_kernels(lexicon, 3, blank_optional, spike)
    assert tables.num_params == ref.num_params
    for name in convkernel._FIELDS:
        got, want = getattr(tables, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for entry in lexicon:
        g = make_kernel_graph(list(entry), 3, blank_optional, spike)
        j = jtrans.make_kernel_graph(list(entry), 3, blank_optional, spike)
        assert (g.start, g.finals, list(g.arcs())) == (j.start, j.finals, list(j.arcs()))
    # one parameter a kernel-graph arc, in the graph's arc order
    assert tables.num_params == sum(
        make_kernel_graph(list(e), 3, blank_optional, spike).num_arcs() for e in lexicon)


@pytest.mark.parametrize("padded", [False, True])
def test_make_windows_matches_jax(padded):
    x = np.random.RandomState(1).randn(2, 11, 4).astype(np.float32)
    for K, stride in ((5, 2), (3, 1), (7, 4)):
        got = convkernel.make_windows(torch.from_numpy(x), K, stride, padded)
        want = np.asarray(jck.make_windows(jnp.asarray(x), K, stride, padded))
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def _jax_layer(lexicon, K, stride, blank, kwargs, x, params, g):
    conv = jtrans.ConvTransduce1D(lexicon, K, stride, blank, **kwargs)

    @jax.jit
    def fwd_bwd(x, params, g):
        out, vjp = jax.vjp(lambda x, p: conv(x, p), x, params)
        return out, vjp(g)

    out, (gx, gp) = fwd_bwd(jnp.asarray(x), None if params is None else jnp.asarray(params),
                            jnp.asarray(g))
    return np.asarray(out), np.asarray(gx), None if gp is None else np.asarray(gp)


def _port_layer(lexicon, K, stride, blank, kwargs, x, params, g):
    conv = ConvTransduce1D(lexicon, K, stride, blank, **kwargs)
    if params is not None:
        with torch.no_grad():
            conv.kernel_params.copy_(torch.from_numpy(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt)
    out.backward(torch.from_numpy(g))
    gp = None if params is None else conv.kernel_params.grad.numpy()
    return out.detach().numpy(), xt.grad.numpy(), gp


def _hold(got, want):
    out, gx, gp = got
    r_out, r_gx, r_gp = want
    np.testing.assert_allclose(out, r_out, rtol=RTOL, atol=ATOL)
    for a, b in ((gx, r_gx), (gp, r_gp)):
        if b is None:
            assert a is None
            continue
        assert np.isfinite(a).all()
        assert np.all(np.abs(a - b) <= GRAD_ATOL + GRAD_RTOL * np.abs(b)), np.abs(a - b).max()


CASES = [
    # (viterbi, learn_params, scale, normalize)
    (False, False, "none", "none"),
    (False, True, "sqrt", "none"),
    (False, False, "linear", "post"),
    (False, True, "none", "pre"),
    (True, False, "none", "none"),
    (True, True, "sqrt", "none"),
    (True, False, "sqrt", "post"),
    (True, True, "linear", "pre"),
]


@pytest.mark.parametrize("viterbi,learn,scale,normalize", CASES)
def test_scores_and_gradients_match_jax(viterbi, learn, scale, normalize):
    rng = np.random.RandomState(2)
    C, blank, K, stride = 4, 4, 7, 2
    lexicon = _lexicon(rng, 9, C) + [(0, 0, 1), (2, 2)]
    x = rng.randn(2, 13, C + 1).astype(np.float32)
    kwargs = dict(viterbi=viterbi, learn_params=learn, scale=scale, normalize=normalize)
    n = convkernel.compile_kernels(lexicon, blank).num_params
    params = (0.3 * rng.randn(n)).astype(np.float32) if learn else None
    W = (13 - 1) // stride + 1
    g = rng.randn(2, W, len(lexicon)).astype(np.float32)
    got = _port_layer(lexicon, K, stride, blank, kwargs, x, params, g)
    _hold(got, _jax_layer(lexicon, K, stride, blank, kwargs, x, params, g))
    assert got[0].shape == (2, W, len(lexicon))
    if learn:
        assert np.abs(got[2]).sum() > 0


@pytest.mark.parametrize("learn", [False, True])
def test_viterbi_ties_split_the_gradient_as_jax(learn):
    """Integer scores and zero arc weights: paths tie all the time, and
    the gradient splits evenly among tied maxima on both sides."""
    rng = np.random.RandomState(3)
    C, blank = 3, 3
    lexicon = _lexicon(rng, 8, C) + [(1, 1), (0, 1, 0)]
    x = rng.randint(-2, 3, (2, 10, C + 1)).astype(np.float32)
    n = convkernel.compile_kernels(lexicon, blank).num_params
    params = np.zeros(n, np.float32) if learn else None
    g = np.ones((2, 10, len(lexicon)), np.float32)
    kwargs = dict(viterbi=True, learn_params=learn)
    got = _port_layer(lexicon, 5, 1, blank, kwargs, x, params, g)
    _hold(got, _jax_layer(lexicon, 5, 1, blank, kwargs, x, params, g))
    # a split share: some input gradients are not whole numbers
    assert np.any(np.abs(got[1] - np.round(got[1])) > 1e-3)


@pytest.mark.parametrize("viterbi", [False, True])
def test_chunked_route_matches_jax(monkeypatch, viterbi):
    """Past the threshold and with V > 128 both score the vocabulary in
    chunks of 128 padded with dead entries, each recomputed in the
    backward (``torch.utils.checkpoint`` / ``jax.checkpoint``)."""
    rng = np.random.RandomState(9)
    C, blank = 3, 3
    lexicon = _lexicon(rng, 150, C, max_len=2)
    n = convkernel.compile_kernels(lexicon, blank).num_params
    params = (0.2 * rng.randn(n)).astype(np.float32)
    x = rng.randn(2, 12, C + 1).astype(np.float32)
    g = rng.randn(2, 6, len(lexicon)).astype(np.float32)
    kwargs = dict(viterbi=viterbi, learn_params=True)
    direct = _port_layer(lexicon, 5, 2, blank, kwargs, x, params, g)
    calls = []
    real = convkernel._conv_scores_chunked
    monkeypatch.setattr(convkernel, "_conv_scores_chunked",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(convkernel, "_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(jck, "_CHUNK_THRESHOLD", 1)
    chunked = _port_layer(lexicon, 5, 2, blank, kwargs, x, params, g)
    assert calls
    _hold(chunked, _jax_layer(lexicon, 5, 2, blank, kwargs, x, params, g))
    _hold(chunked, direct)


def _host_scores(window, lexicon, blank, viterbi):
    """Each lexicon entry's kernel graph intersected with the window's
    emission lattice by the port's host graph operations."""
    K, C = window.shape
    em = Graph()
    em.add_node(True, K == 0)
    for t in range(K):
        em.add_node(False, t == K - 1)
        for c in range(C):
            em.add_arc(t, t + 1, c, c, float(window[t, c]))
    score = ops.viterbi_score if viterbi else ops.forward_score
    return [score(ops.intersect(em, make_kernel_graph(list(e), blank, True)))
            for e in lexicon]


@pytest.mark.parametrize("viterbi", [False, True])
def test_scores_match_host_graph_operations(viterbi):
    rng = np.random.RandomState(4)
    lexicon = [(0,), (1,), (0, 1), (1, 0), (0, 1, 0), (1, 1)]
    K, stride, C = 7, 2, 3
    x = torch.from_numpy(rng.randn(1, 9, C).astype(np.float32))
    out = ConvTransduce1D(lexicon, K, stride, 2, viterbi=viterbi)(x)[0]
    windows = convkernel.make_windows(x, K, stride)[0]
    host = np.array([_host_scores(w.numpy(), lexicon, 2, viterbi) for w in windows])
    np.testing.assert_allclose(out.numpy(), host, rtol=1e-5, atol=1e-5)


def test_shapes_and_refusals_match_jax():
    lexicon = [(0, 0), (0, 1), (1, 0), (1, 1)]
    conv = ConvTransduce1D(lexicon, kernel_size=5, stride=3, blank_idx=2)
    rng = np.random.RandomState(0)
    for Ti, To in zip((1, 3, 4, 6, 7, 8), (1, 1, 2, 2, 3, 3)):
        out = conv(torch.from_numpy(rng.randn(2, Ti, 3).astype(np.float32)))
        assert out.shape == (2, To, len(lexicon))
    # a repeated neighbour counts twice: (1, 1, 1) needs a kernel of 5
    for args, kw, match in (
            (([(1, 1, 1)], 3, 1, 2), {}, "at least 5"),
            (([(0,)], 4, 1, 2), {}, "odd kernel"),
            (([(0,)], 3, 1, 2), {"scale": "cube"}, "Unknown scale"),
            (([(0,)], 3, 1, 2), {"normalize": "both"}, "Unknown normalization")):
        with pytest.raises(ValueError, match=match):
            ConvTransduce1D(*args, **kw)
        with pytest.raises(ValueError, match=match):
            jtrans.ConvTransduce1D(*args, **kw)
    ConvTransduce1D([(1, 1, 1)], 5, 1, 2)
    with pytest.raises(ValueError):
        convkernel.make_windows(torch.zeros(1, 0, 3), 5, 1)
    with pytest.raises(ValueError, match="shorter than one kernel"):
        convkernel.make_windows(torch.zeros(1, 4, 3), 5, 1, padded=True)
    # the learned weights are a parameter, zero at the start; the tables
    # follow the module's device and stay out of its state_dict
    learned = ConvTransduce1D(lexicon, 5, 3, 2, learn_params=True)
    assert [n for n, _ in learned.named_parameters()] == ["kernel_params"]
    assert not learned.kernel_params.detach().any()
    assert list(learned.state_dict()) == ["kernel_params"]
    assert learned.tables.label.dtype == torch.int64
