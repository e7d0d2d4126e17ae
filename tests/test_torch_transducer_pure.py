"""The Transducer and the graph helpers without the native library
(``TW_NATIVE=0``), against JAX's Python pipeline and the port's native
route.

With ``TW_NATIVE=0`` (set by ``monkeypatch``, JAX's cached library handle
reset so that JAX reads it too) both packages compile each target through
the Python graph operations: chain o lexicon, output side, epsilons
removed, the token graph composed with it, input side, the transitions
composed in with their arc provenance.  The port's compiled tables equal
JAX's arc for arc; its losses and gradients (ngram 0-2, blank none,
optional and forced, through the composed and the factored routes) equal JAX's
Python pipeline's and its own native route's within 1e-5; the forced
decode's tokens equal JAX's Python transduction and the native
``forced_collapse`` exactly.  ``compile_acceptor(remove_eps=True)`` and
``linear_graph(T, C)`` equal JAX's arc for arc, and the ``Graph`` helpers
(``weights``, ``labels_to_list``, ``is_acceptor``) JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu.wfst import compile as jax_wcompile
from gtn_applications_tpu.wfst import graph as jax_graph
from gtn_applications_tpu.wfst import native as jnative
from gtn_applications_tpu_torch.criterions import transducer as td
from gtn_applications_tpu_torch.wfst import EPSILON, compile as wcompile
from gtn_applications_tpu_torch.wfst import graph as wgraph

TOL = dict(rtol=1e-5, atol=1e-5)
WORD_TOKENS = ["ab", "ba", "a", "b", "bb"]
# (tokens, Transducer options, label range of the targets, the loss's
# route: the composed arc table, or the dense tables of the factored scan)
CASES = {
    "ngram0_none": (None, dict(blank="none"), 6, "factored"),
    "ngram0_optional_words": (WORD_TOKENS, dict(blank="optional", allow_repeats=False), 2,
                              "composed"),
    "ngram1_forced": (None, dict(ngram=1, blank="forced"), 6, "composed"),
    "ngram2_none": (None, dict(ngram=2, blank="none"), 6, "factored"),
    "ngram2_optional_norep": (None, dict(ngram=2, blank="optional", allow_repeats=False), 6,
                              "factored"),
    "ngram2_forced": (None, dict(ngram=2, blank="forced"), 6, "factored"),
}


@pytest.fixture
def no_native(monkeypatch):
    """``TW_NATIVE=0`` for both packages: JAX reads it when it loads its
    library, so its cached handle is dropped for the test."""
    monkeypatch.setenv("TW_NATIVE", "0")
    monkeypatch.setattr(jnative, "_LIB", None)


def _criteria(name):
    tokens, kw = CASES[name][:2]
    kw = dict(kw, reduction="mean")
    if tokens is None:
        args = ([(i,) for i in range(6)], {i: i for i in range(6)})
    else:
        args = (tokens, {"a": 0, "b": 1})
    return td.Transducer(*args, **kw), jax_td.Transducer(*args, **kw)


def _targets(name, rng, B=3):
    n = CASES[name][2]
    if n == 2:
        return [[0, 1, 0], [1, 1], [0, 0, 1]]
    return [rng.randint(0, n, size=rng.randint(2, 5)).tolist() for _ in range(B)]


def _same_compiled(got, want):
    cg, widx, eps_widx = got
    jcg, jwidx, jeps_widx = want
    for field in cg._fields:
        np.testing.assert_array_equal(np.asarray(getattr(cg, field)),
                                      np.asarray(getattr(jcg, field)), err_msg=field)
    np.testing.assert_array_equal(widx, jwidx)
    np.testing.assert_array_equal(eps_widx, jeps_widx)


@pytest.mark.parametrize("name", list(CASES))
def test_compiled_targets_match_jax_python(name, no_native):
    crit, jcrit = _criteria(name)
    assert crit._native_handles() is None and jcrit._native_handles() is None
    for target in _targets(name, np.random.RandomState(0)):
        key = tuple(target)
        for compose in (True, False):
            _same_compiled(crit._compile_target(key, compose),
                           jcrit._compile_target(key, compose))


def _port_loss(crit, x, lens, trans, targets):
    p = {"transitions": torch.from_numpy(trans).requires_grad_(True)} if trans is not None else {}
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss(p, x_t, crit.prepare(targets), torch.from_numpy(lens))
    grads = torch.autograd.grad(loss, [x_t] + list(p.values()))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_without_native_matches_jax_and_native(name, monkeypatch):
    route = CASES[name][3]
    rng = np.random.RandomState(5)
    targets = _targets(name, rng)
    crit, _ = _criteria(name)
    B, T, N = len(targets), 10, crit.num_channels
    x = rng.randn(B, T, N).astype(np.float32)
    lens = np.asarray([T, T - 2, T - 3], np.int32)[:B]
    trans = ((rng.randn(crit.num_transition_arcs) * 0.3).astype(np.float32)
             if crit.num_transition_arcs else None)
    monkeypatch.setattr(td, "_FACTORED_IMPL", "off" if route == "composed" else "auto")
    monkeypatch.setattr(jax_td, "_FACTORED_IMPL", "off" if route == "composed" else "on")

    native_loss, native_grads = _port_loss(crit, x, lens, trans, targets)
    monkeypatch.setenv("TW_NATIVE", "0")
    monkeypatch.setattr(jnative, "_LIB", None)
    crit, jcrit = _criteria(name)
    assert crit._native_handles() is None
    loss, grads = _port_loss(crit, x, lens, trans, targets)

    params = {"transitions": jnp.asarray(trans)} if trans is not None else {}
    jprep = jcrit.prepare(targets)
    j_loss, (j_gp, j_gx) = jax.value_and_grad(
        lambda p, x: jcrit.loss(p, x, jprep, jnp.asarray(lens)), argnums=(0, 1))(
        params, jnp.asarray(x))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(j_loss), **TOL)
    np.testing.assert_allclose(loss, native_loss, **TOL)
    np.testing.assert_allclose(grads[0], np.asarray(j_gx), err_msg="logits", **TOL)
    np.testing.assert_allclose(grads[0], native_grads[0], err_msg="logits", **TOL)
    if trans is not None:
        np.testing.assert_allclose(grads[1], np.asarray(j_gp["transitions"]),
                                   err_msg="transitions", **TOL)
        np.testing.assert_allclose(grads[1], native_grads[1], err_msg="transitions", **TOL)


def _forced_paths(rng, ntok, B=12, T=16):
    """Alignment paths over ntok tokens and the blank ntok: half built to
    fit the forced token graph (blank runs around and between token runs),
    half random; -1 on some dead frames."""
    paths = np.full((B, T), -1, np.int32)
    for b in range(B):
        if b % 2:
            paths[b] = rng.randint(0, ntok + 1, size=T)
            continue
        seq = []
        while len(seq) < T:
            seq += [ntok] * rng.randint(1, 3) + [rng.randint(0, ntok)] * rng.randint(1, 3)
        seq = (seq[:T - 1] + [ntok])
        paths[b] = seq
    paths[0, -3:] = -1
    return paths


def test_forced_decode_without_native_matches_jax_and_native(monkeypatch):
    crit, jcrit = _criteria("ngram2_forced")
    ntok = crit._num_tokens
    rng = np.random.RandomState(2)
    paths = _forced_paths(rng, ntok)
    lens = np.asarray([16, 16, 12, 16, 9, 16, 16, 3, 16, 16, 16, 0], np.int32)
    native_out = crit._transduce(paths, lens)
    monkeypatch.setenv("TW_NATIVE", "0")
    monkeypatch.setattr(jnative, "_LIB", None)
    got = crit._transduce(paths, lens)
    want = jcrit._transduce(paths, lens)
    as_lists = [[int(v) for v in p] for p in got]
    assert as_lists == [[int(v) for v in p] for p in want]
    assert as_lists == [[int(v) for v in p] for p in native_out]
    assert sum(bool(p) for p in as_lists) >= 4 and not all(as_lists)


def _random_graph(module, rng, S=7, A=18, C=4):
    g = module.Graph()
    for i in range(S):
        g.add_node(i == 0, i >= S - 2)
    for _ in range(A):
        s = rng.randint(0, S - 1)
        d = rng.randint(s + 1, S)
        lbl = EPSILON if rng.rand() < 0.3 else rng.randint(0, C)
        g.add_arc(s, d, lbl, lbl, float(np.float32(rng.randn())))
    return g


def test_compile_acceptor_remove_eps_without_native_matches_jax(no_native):
    for seed in range(4):
        g = _random_graph(wgraph, np.random.RandomState(seed))
        jg = _random_graph(jax_graph, np.random.RandomState(seed))
        for semiring in ("log", "tropical"):
            got = wcompile.compile_acceptor(g, semiring, remove_eps=True)
            want = jax_wcompile.compile_acceptor(jg, semiring, remove_eps=True)
            assert len(got.eps_src) == 0
            _same_compiled((got, np.zeros(0), np.zeros(0)), (want, np.zeros(0), np.zeros(0)))


@pytest.mark.parametrize("shape", [(0, 3), (1, 1), (4, 5)])
def test_linear_graph_lattice_and_helpers_match_jax(shape):
    g, jg = wgraph.linear_graph(*shape), jax_graph.linear_graph(*shape)
    assert (g.start, g.finals, list(g.arcs())) == (jg.start, jg.finals, list(jg.arcs()))
    weights = list(np.arange(g.num_arcs(), dtype=np.float32) * 0.5)
    g.set_weights(weights)
    jg.set_weights(weights)
    assert g.weights() == jg.weights() == [float(w) for w in weights]
    assert g.is_acceptor() and jg.is_acceptor()
    chain = wgraph.linear_graph([3, 1, 2])
    assert chain.labels_to_list() == jax_graph.linear_graph([3, 1, 2]).labels_to_list()
    t, jt = td.make_token_graph(list("ab"), "forced", True), \
        jax_td.make_token_graph(list("ab"), "forced", True)
    for ilabel in (True, False):
        assert t.labels_to_list(ilabel) == jt.labels_to_list(ilabel)
    assert t.is_acceptor() == jt.is_acceptor() is False
