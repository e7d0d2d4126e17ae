"""The port's host WFST operations (``wfst/ops.py``, the native bindings
of ``wfst/native.py``, ``write_dot``, and ``utils.edit_distance`` by its
native DP) against the JAX package's, on random small graphs made with
numpy from a seed.

Each function runs by both routes, the Python one (``*_py``) and the
native graph compiler: the port's route against the same route of JAX's,
exactly (the same code, or the same library); the native route against
the Python one by structure and scores within 1e-5.
"""

import numpy as np
import pytest

from gtn_applications_tpu import wfst as jwfst
from gtn_applications_tpu.wfst import native as jnative
from gtn_applications_tpu.wfst import ops as jops
from gtn_applications_tpu_torch import wfst
from gtn_applications_tpu_torch.wfst import EPSILON, Graph, native
from gtn_applications_tpu_torch.wfst import ops

SCORE_TOL = 1e-5


def _spec(rng, S=8, A=20, C=4, eps_frac=0.25, acyclic=False, finals=True):
    """A random transducer as (nodes, finals, arcs): forward arcs only, so
    epsilon paths stay acyclic, plus a self-loop a node unless ``acyclic``;
    weighted finals unless ``finals`` is False."""
    nodes = [(i == 0, False) for i in range(S)]
    fin = [(i, float(rng.randn() * 0.5) if finals else 0.0) for i in (S - 2, S - 1)]
    arcs = []
    for _ in range(A):
        s = rng.randint(0, S - 1)
        d = rng.randint(s + 1 if acyclic else s, S)
        if rng.rand() < eps_frac and d > s:
            arcs.append((s, d, EPSILON, EPSILON, float(rng.randn() * 0.5)))
        else:
            il = rng.randint(0, C)
            ol = rng.randint(0, C) if rng.rand() < 0.5 else il
            arcs.append((s, min(d, S - 1), il, ol, float(rng.randn() * 0.5)))
    if not acyclic:
        for i in range(S):
            lbl = rng.randint(0, C)
            arcs.append((i, i, lbl, lbl, float(rng.randn() * 0.5)))
    return nodes, fin, arcs


def _build(cls, spec):
    nodes, fin, arcs = spec
    g = cls()
    for start, accept in nodes:
        g.add_node(start, accept)
    for node, w in fin:
        g.add_final(node, w)
    for arc in arcs:
        g.add_arc(*arc)
    return g


def _pair(spec):
    return _build(Graph, spec), _build(jwfst.Graph, spec)


def _fields(g):
    return (list(g.start), {k: list(v) for k, v in g.finals.items()},
            list(g.arcs()))


def _same(port, ref):
    """The port's graph is the JAX graph, field by field, in order."""
    assert _fields(port) == _fields(ref)


def _same_float32(native_g, g):
    """The native graph is ``g`` but for weights rounded to float32."""
    start, fin, arcs = _fields(native_g)
    start_r, fin_r, arcs_r = _fields(g)
    assert start == start_r and fin.keys() == fin_r.keys()
    for k in fin:
        np.testing.assert_allclose(fin[k], fin_r[k], rtol=1e-6, atol=1e-7)
    assert [a[:4] for a in arcs] == [a[:4] for a in arcs_r]
    np.testing.assert_allclose([a[4] for a in arcs], [a[4] for a in arcs_r],
                               rtol=1e-6, atol=1e-7)


def _chain_scores(g, fwd):
    """Forward scores of g's input side against short label chains."""
    out = []
    for seq in ([0], [0, 1], [1, 0, 1]):
        out.append(fwd(ops.compose_py(ops.project_input(g), wfst.linear_graph(seq))))
    return out


def _close(a, b):
    dead = a < -1e29 and b < -1e29
    assert dead or abs(a - b) <= SCORE_TOL * max(1.0, abs(a)), (a, b)


def _equivalent(a, b):
    """Native against Python: node ids may differ, so compare counts,
    sorted labels and weights, and scores against label chains."""
    assert (a.num_nodes(), a.num_arcs(), a.num_start(), a.num_accept()) == (
        b.num_nodes(), b.num_arcs(), b.num_start(), b.num_accept())
    assert sorted(a.arc_ilabel) == sorted(b.arc_ilabel)
    assert sorted(a.arc_olabel) == sorted(b.arc_olabel)
    np.testing.assert_allclose(sorted(a.arc_weight), sorted(b.arc_weight),
                               rtol=1e-6, atol=1e-6)
    for sa, sb in zip(_chain_scores(a, ops.forward_score_py),
                      _chain_scores(b, ops.forward_score_py)):
        _close(sa, sb)


@pytest.mark.parametrize("seed", range(4))
def test_compose_and_intersect(seed):
    rng = np.random.RandomState(seed)
    s1, s2 = _spec(rng, eps_frac=0.3), _spec(rng)
    (g1, j1), (g2, j2) = _pair(s1), _pair(s2)
    out, prov = ops.compose_py(g1, g2, return_arc_map=True)
    ref, ref_prov = jops.compose_py(j1, j2, return_arc_map=True)
    _same(out, ref)
    assert prov == ref_prov
    nout, nprov = native.compose(g1, g2, return_arc_map=True)
    nref, nref_prov = jnative.compose(j1, j2, return_arc_map=True)
    _same(nout, nref)
    assert nprov == nref_prov
    _equivalent(nout, out)
    # provenance: each arc's labels and weight from the arcs it came from
    for g, pv in ((out, prov), (nout, nprov)):
        for a, (a1, a2) in enumerate(pv):
            il = g1.arc_ilabel[a1] if a1 >= 0 else EPSILON
            ol = g2.arc_olabel[a2] if a2 >= 0 else EPSILON
            w = (g1.arc_weight[a1] if a1 >= 0 else 0.0) + (
                g2.arc_weight[a2] if a2 >= 0 else 0.0)
            assert (g.arc_ilabel[a], g.arc_olabel[a]) == (il, ol)
            assert abs(g.arc_weight[a] - w) < 1e-6
    # intersect of acceptors, by the dispatcher (native here) and Python
    a1, a2 = (_pair(_spec(rng, eps_frac=0.0)) for _ in range(2))
    a1 = tuple(jops.project_input(x) if isinstance(x, jwfst.Graph)
               else ops.project_input(x) for x in a1)
    a2 = tuple(jops.project_input(x) if isinstance(x, jwfst.Graph)
               else ops.project_input(x) for x in a2)
    _same(wfst.intersect(a1[0], a2[0]), jwfst.intersect(a1[1], a2[1]))


@pytest.mark.parametrize("seed", range(3))
def test_projections_and_trim(seed):
    rng = np.random.RandomState(10 + seed)
    spec = _spec(rng)
    # a dead branch: unreachable node 8 and a node 9 that reaches no accept
    nodes, fin, arcs = spec
    spec = (nodes + [(False, False), (False, False)], fin,
            arcs + [(8, 3, 1, 1, 0.5), (2, 9, 0, 2, -0.25)])
    g, j = _pair(spec)
    _same(ops.project_input(g), jops.project_input(j))
    _same(ops.project_output(g), jops.project_output(j))
    _same_float32(native.project(g, True), ops.project_input(g))
    _same_float32(native.project(g, False), ops.project_output(g))
    t, tj = ops.trim(g), jops.trim(j)
    _same(t, tj)
    assert t.num_nodes() < g.num_nodes()
    _same(native.trim(g), jnative.trim(j))
    _equivalent(native.trim(g), t)


@pytest.mark.parametrize("seed", range(4))
def test_remove(seed):
    rng = np.random.RandomState(20 + seed)
    spec = _spec(rng, eps_frac=0.35)
    g, j = _pair(spec)
    out = ops.remove_py(g)
    _same(out, jops.remove_py(j))
    assert all(not (i == EPSILON and o == EPSILON)
               for i, o in zip(out.arc_ilabel, out.arc_olabel))
    nout = native.remove(g)
    _same(nout, jnative.remove(j))
    _same(wfst.remove(g), jwfst.remove(j))
    for sa, sb in zip(_chain_scores(nout, ops.forward_score_py),
                      _chain_scores(out, ops.forward_score_py)):
        _close(sa, sb)


def test_remove_refuses_an_epsilon_cycle():
    spec = ([(True, False), (False, True)], [],
            [(0, 1, EPSILON, EPSILON, 0.0), (1, 0, EPSILON, EPSILON, 0.0)])
    g, j = _pair(spec)
    with pytest.raises(ValueError, match="epsilon cycle"):
        ops.remove_py(g)
    with pytest.raises(ValueError):
        native.remove(g)
    with pytest.raises(ValueError, match="epsilon cycle"):
        jops.remove_py(j)


@pytest.mark.parametrize("seed", range(5))
def test_scores_and_best_path(seed):
    rng = np.random.RandomState(30 + seed)
    spec = _spec(rng, S=7, A=15, C=3, eps_frac=0.2, acyclic=True)
    g, j = _pair(spec)
    for fn, jfn in ((ops.forward_score_py, jops.forward_score_py),
                    (ops.viterbi_score_py, jops.viterbi_score_py)):
        assert fn(g) == jfn(j)
    for fn, jfn in ((native.forward_score, jnative.forward_score),
                    (native.viterbi_score, jnative.viterbi_score)):
        assert fn(g) == jfn(j)
    _close(native.forward_score(g), ops.forward_score_py(g))
    _close(native.viterbi_score(g), ops.viterbi_score_py(g))
    # the dispatchers take the native route, as JAX's do
    assert wfst.forward_score(g) == native.forward_score(g)
    assert wfst.viterbi_score(g) == native.viterbi_score(g)
    path = wfst.viterbi_path(g)
    _same(path, jwfst.viterbi_path(j))
    # the best path is a chain whose weights sum to the Viterbi score less
    # the final weight of the state it ends in
    best = ops.viterbi_score_py(g)
    assert best > ops.NEG / 2 and path.num_arcs() > 0
    assert any(abs(sum(path.arc_weight) + w - best) < 1e-9
               for ws in g.finals.values() for w in ws)


def test_scores_refuse_cycles_and_score_dead_graphs():
    spec = ([(True, False), (False, True)], [], [(0, 1, 0, 0, 0.0), (1, 0, 1, 1, 0.0)])
    g, j = _pair(spec)
    for fn in (ops.forward_score_py, ops.viterbi_score_py, ops.viterbi_path,
               native.forward_score, native.viterbi_score):
        with pytest.raises(ValueError, match="cycles"):
            fn(g)
    dead = ([(True, False), (False, True)], [], [])
    g, j = _pair(dead)
    assert ops.forward_score_py(g) == jops.forward_score_py(j) == ops.NEG
    assert ops.viterbi_score_py(g) == jops.viterbi_score_py(j)
    assert ops.viterbi_path(g).num_nodes() == 0


def test_native_dispatch_follows_tw_native(monkeypatch):
    """``compose``, ``remove``, ``forward_score`` and ``viterbi_score`` take
    the native library where it loads and ``TW_NATIVE`` is not 0, as JAX's
    ``_use_native`` does; else the Python versions."""
    rng = np.random.RandomState(40)
    g1, g2 = _build(Graph, _spec(rng)), _build(Graph, _spec(rng))
    dag = _build(Graph, _spec(rng, acyclic=True))
    assert ops._use_native() == jops._use_native() is True
    _same(ops.compose(g1, g2), native.compose(g1, g2))
    _same(ops.remove(g1), native.remove(g1))
    monkeypatch.setenv("TW_NATIVE", "0")
    assert not ops._use_native()
    _same(ops.compose(g1, g2), ops.compose_py(g1, g2))
    _same(ops.remove(g1), ops.remove_py(g1))
    assert ops.forward_score(dag) == ops.forward_score_py(dag)
    assert ops.viterbi_score(dag) == ops.viterbi_score_py(dag)


def _relabelled(spec, rng):
    """The same graph with its nodes renumbered (node 0 stays the start)
    and its arcs shuffled."""
    nodes, fin, arcs = spec
    perm = np.concatenate([[0], 1 + rng.permutation(len(nodes) - 1)])
    inv = np.argsort(perm)
    new_nodes = [nodes[int(perm[i])] for i in range(len(nodes))]
    new_fin = [(int(inv[n]), w) for n, w in fin]
    new_arcs = [(int(inv[s]), int(inv[d]), il, ol, w) for s, d, il, ol, w in arcs]
    new_arcs = [new_arcs[i] for i in rng.permutation(len(new_arcs))]
    return new_nodes, new_fin, new_arcs


@pytest.mark.parametrize("seed", range(4))
def test_equal_and_isomorphic(seed):
    rng = np.random.RandomState(50 + seed)
    spec = _spec(rng, S=6, A=10, C=3, eps_frac=0.0)
    nodes, fin, arcs = spec
    shuffled = (nodes, fin, [arcs[i] for i in rng.permutation(len(arcs))])
    relabelled = _relabelled(spec, rng)
    # a weight changed on an arc out of the start (isomorphic compares the
    # part reachable from the start nodes)
    i = next(i for i, arc in enumerate(arcs) if arc[0] == 0)
    s, d, il, ol, w = arcs[i]
    changed = (nodes, fin, arcs[:i] + [(s, d, il, ol, w + 1.0)] + arcs[i + 1:])
    g, j = _pair(spec)
    for other in (spec, shuffled, relabelled, changed):
        h, k = _pair(other)
        assert ops.equal(g, h) == jops.equal(j, k)
        assert ops.isomorphic(g, h) == jops.isomorphic(j, k)
    assert ops.equal(g, _build(Graph, shuffled))
    assert ops.isomorphic(g, _build(Graph, relabelled))
    assert not ops.isomorphic(g, _build(Graph, changed))
    assert not ops.equal(g, _build(Graph, changed))


def test_write_dot_matches_jax(tmp_path):
    rng = np.random.RandomState(60)
    g, j = _pair(_spec(rng, eps_frac=0.3))
    syms = {0: "a", 1: "b", 2: "c"}
    for isym, osym in ((None, None), (syms, None), (syms, syms)):
        wfst.write_dot(g, tmp_path / "port.dot", isym, osym)
        jwfst.write_dot(j, tmp_path / "jax.dot", isym, osym)
        assert (tmp_path / "port.dot").read_bytes() == (tmp_path / "jax.dot").read_bytes()


def test_edit_distance_native_and_python_match_jax(monkeypatch):
    """``utils.edit_distance`` takes the native DP where the library is
    enabled, as JAX's does, and the Python one under ``TW_NATIVE=0``."""
    from gtn_applications_tpu import utils as jutils
    from gtn_applications_tpu_torch import utils

    rng = np.random.RandomState(70)
    pairs = [(list(rng.randint(0, 4, rng.randint(0, 12))),
              list(rng.randint(0, 4, rng.randint(0, 12)))) for _ in range(30)]
    pairs += [("kitten", "sitting"), (["ab", "c"], ["ab", "d", "c"]), ("", "abc")]
    want = [jutils.edit_distance(a, b) for a, b in pairs]
    calls = []
    real = native.edit_distance_i32
    monkeypatch.setattr(native, "edit_distance_i32", lambda *x: calls.append(1) or real(*x))
    assert [utils.edit_distance(a, b) for a, b in pairs] == want
    assert len(calls) == len(pairs)
    monkeypatch.setenv("TW_NATIVE", "0")
    assert [utils.edit_distance(a, b) for a, b in pairs] == want
    assert len(calls) == len(pairs)
