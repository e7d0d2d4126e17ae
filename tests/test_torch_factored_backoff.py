"""The port's backoff factorings against the JAX package's.

A loaded (pruned, backoff) transition graph can be scored against the
alignment lattices without composing it into them (``ops/factored.py``):
the dense variant (``backoff_factored_score``, ``backoff_dense_norm``), the
destination-factored one (``backoff_dst_factored_score``, its staged form,
and ``backoff_dst_exp_score``, the exp-linear tier, with
``backoff_dst_norm``), each closure dense or low-rank (``eps_chain_struct``,
``eps_lowrank_build``), and the decode ``backoff_dst_viterbi``.  Held to JAX
on the CPU, function by function, on four graphs: JAX's unigram-backoff
bigram (``tests/test_factored.py``), a bigram built by ``build_transitions``,
the grapheme trigram and a backoff chain of depth 2 from a start state.  Each
batch holds a ragged sample, a zero-length sample with the empty target
(the empty path exists), one without it and an untransducible target.
Scores and normalisers within rtol 1e-5 + atol 1e-5, their gradients to the
emissions and the transitions within rtol 1e-4 + atol 1e-6; the decode's
labels exactly, its scores within 1e-5.  Also the Transducer's routes: the
dst loss under both ``GTN_FACTORED_VJP`` settings, ``auto`` composing a
loaded graph, and the factored decode against the composed one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import wfst as jax_wfst
from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu.ops import factored as jax_fact
from gtn_applications_tpu_torch.criterions import transducer as td
from gtn_applications_tpu_torch.ops import factored
from gtn_applications_tpu_torch.scripts import build_transitions as bt
from gtn_applications_tpu_torch.wfst import graph as wgraph

from tests.test_torch_transducer_backoff import GRAD_TOL, LOSS_TOL, _trigram_pair

GRAPHS = {"port": (wgraph.Graph, wgraph.EPSILON), "jax": (jax_wfst.Graph, jax_wfst.EPSILON)}


def _unigram_backoff(side, C=4, seed=0):
    """JAX's ``_backoff_graph``: a unigram hub, a state a label, epsilon
    backoff arcs to the hub and random direct bigram arcs."""
    Graph, eps = GRAPHS[side]
    rng = np.random.default_rng(seed)
    g = Graph()
    uni = g.add_node(True, True)
    for _ in range(C):
        g.add_node(False, True)
    for lbl in range(C):
        g.add_arc(uni, lbl + 1, lbl)
        g.add_arc(lbl + 1, uni, eps)
    for _ in range(2 * C):
        a, b = int(rng.integers(0, C)), int(rng.integers(0, C))
        g.add_arc(a + 1, b + 1, b)
    return g


def _deep_chain(side, ntok=3):
    """JAX's deep-chain graph with its deep state a start state: its best
    continuations route deep -> mid -> root -> an arc (closure depth 2)."""
    Graph, eps = GRAPHS[side]
    g = Graph()
    root = g.add_node(True, True)
    ctx1 = [g.add_node(False, True) for _ in range(ntok)]
    deep = g.add_node(True, True)
    mid = g.add_node(False, True)
    g.add_arc(deep, mid, eps)
    g.add_arc(mid, root, eps)
    for lbl in range(ntok):
        g.add_arc(root, ctx1[lbl], lbl)
        g.add_arc(ctx1[lbl], root, eps)
    g.add_arc(ctx1[0], ctx1[1], 1)
    g.add_arc(ctx1[1], ctx1[0], 0)
    g.add_arc(deep, ctx1[2], 2)
    g.add_arc(deep, deep, 0)
    return g


def _bigram_lines(seed=7, ntok=4):
    rng = np.random.RandomState(seed)
    return [[str(i) for i in rng.randint(0, ntok, rng.randint(3, 9))] for _ in range(150)]


def _pair(name, tmp_path):
    """(port, JAX) Transducers over the named graph (weights learnable)."""
    kw = dict(reduction="mean")
    if name == "trigram":
        return _trigram_pair()
    if name == "unigram_backoff":
        toks, g2i = ["a", "b", "c"], {c: i for i, c in enumerate("abc")}
        gs = {side: _unigram_backoff(side) for side in GRAPHS}
        kw["blank"] = "optional"
    elif name == "deep_chain":
        toks, g2i = ["0", "1", "2"], {str(i): i for i in range(3)}
        gs = {side: _deep_chain(side) for side in GRAPHS}
        kw["blank"] = "none"
    else:  # build_transitions: a pruned bigram with blanks and self-loops
        toks, g2i = [str(i) for i in range(4)], {str(i): i for i in range(4)}
        path = tmp_path / "bigram.bin"
        wgraph.save(path, bt.build_from_lines(_bigram_lines(), toks, [0, 0], "optional",
                                              self_loops=True))
        gs = {"port": wgraph.load(path), "jax": jax_wfst.load(path)}
        kw["blank"] = "optional"
    return (td.Transducer(toks, g2i, transitions=gs["port"], **kw),
            jax_td.Transducer(toks, g2i, transitions=gs["jax"], **kw))


CASES = ("unigram_backoff", "bigram", "trigram", "deep_chain")
# a ragged sample, the empty target at length 0 (the empty path), a target
# at length 0 (no empty path) and an untransducible target (grapheme 50)
TARGETS = [[2, 0, 1], [1], [], [0, 50]]
T = 10
LENS = np.asarray([T, T - 4, 0, 0], np.int32)


def _batch(crit, jcrit, monkeypatch, seed=0):
    """Both criteria's factored tables of ``TARGETS`` (``on``), random
    logits and transitions."""
    monkeypatch.setattr(td, "_FACTORED_IMPL", "on")
    monkeypatch.setattr(jax_td, "_FACTORED_IMPL", "on")
    prep, jprep = crit.prepare(TARGETS), jcrit.prepare(TARGETS)
    assert "factored" in prep and "factored" in jprep
    rng = np.random.RandomState(seed)
    x = rng.randn(len(TARGETS), T, crit.num_channels).astype(np.float32)
    p = (rng.randn(crit.num_transition_arcs) * 0.4).astype(np.float32)
    return prep["factored"], jprep["factored"], x, p


def _lattice(f, jax_side=False):
    keys = ("adj_exp", "lab_oh", "start", "accept")
    return tuple(jnp.asarray(f[k]) for k in keys) if jax_side else tuple(f[k] for k in keys)


def _hold(fn, jfn, x, p, seed=1):
    """fn(p, x) -> [B] on both sides: the values, and the gradients of their
    sum under random positive weights."""
    c = np.random.RandomState(seed).uniform(0.5, 1.5, x.shape[0]).astype(np.float32)
    j_val, vjp = jax.vjp(jfn, jnp.asarray(p), jnp.asarray(x))
    j_gp, j_gx = vjp(jnp.asarray(c))
    p_t = torch.from_numpy(p).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    val = fn(p_t, x_t)
    gp, gx = torch.autograd.grad((val * torch.from_numpy(c)).sum(), [p_t, x_t])
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(j_val), **LOSS_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), err_msg="emissions", **GRAD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(j_gp), err_msg="transitions",
                               **GRAD_TOL)
    return val.detach().numpy()


def _functions(crit, jcrit, f, jf, which):
    """(port fn, JAX fn) of (params, emissions) for one scorer or
    normaliser, its matrices built by each criterion from the params."""
    N = crit.num_channels
    lat, jlat = _lattice(f), _lattice(jf, jax_side=True)
    lens, jlens = torch.from_numpy(LENS), jnp.asarray(LENS)

    def mats(p, dst):
        w_eff, ew_eff = crit._eff_weights(p)
        if not dst:
            return crit._transition_matrices(w_eff, ew_eff), None
        lowrank = factored.eps_lowrank_build(ew_eff, crit._factored_tables(p.device)["eps_lr"])
        return crit._transition_matrices_dst(w_eff, ew_eff), lowrank

    def jmats(p, dst):
        if not dst:
            return jcrit._transition_matrices(p, N), None
        lowrank = jax_fact.eps_lowrank_build(jcrit._eps_eff_weights(p), jcrit._eps_lr_struct)
        return jcrit._transition_matrices_dst(p, N), lowrank

    low = which.endswith("_lowrank")
    name = which[: -len("_lowrank")] if low else which
    port_fn, jax_fn = {
        "dense_score": (factored.backoff_factored_score, jax_fact.backoff_factored_score),
        "dense_norm": (factored.backoff_dense_norm, jax_fact.backoff_dense_norm),
        "dst_staged": (factored.backoff_dst_factored_score,
                       jax_fact.backoff_dst_factored_score),
        "dst_exp": (factored.backoff_dst_exp_score, jax_fact.backoff_dst_exp_score),
        "dst_norm": (factored.backoff_dst_norm, jax_fact.backoff_dst_norm),
    }[name]
    dst = name.startswith("dst")
    norm = name.endswith("norm")

    def fn(p, x):
        m, lr = mats(p, dst)
        args = (x,) + m if norm else (x,) + lat + m
        kw = {"eps_lowrank": lr if low else None} if dst else {}
        return port_fn(*args, lens, **kw)

    def jfn(p, x):
        m, lr = jmats(p, dst)
        args = (x,) + m if norm else (x,) + jlat + m
        kw = {"eps_lowrank": lr if low else None} if dst else {}
        return jax_fn(*args, jlens, **kw)

    return fn, jfn


DENSE_FNS = ("dense_score", "dense_norm")
DST_FNS = ("dst_staged", "dst_exp", "dst_exp_lowrank", "dst_norm", "dst_norm_lowrank")
SCORERS = [(c, w) for c in CASES for w in DENSE_FNS + (DST_FNS if c != "trigram" else ())]


def _hold_scorer(case, which, tmp_path, monkeypatch, scale=1.0):
    crit, jcrit = _pair(case, tmp_path)
    assert crit._factored_backoff == jcrit._factored_backoff is True
    assert crit._factored_backoff_dst == jcrit._factored_backoff_dst == (case != "trigram")
    if which == "dst_staged":
        monkeypatch.setattr(factored, "_VJP_IMPL", "off")
        monkeypatch.setattr(jax_fact, "_VJP_IMPL", "off")
    f, jf, x, p = _batch(crit, jcrit, monkeypatch)
    fn, jfn = _functions(crit, jcrit, f, jf, which)
    return crit, jcrit, f, jf, x, p, _hold(fn, jfn, x * np.float32(scale), p)


@pytest.mark.parametrize("case,which", SCORERS)
def test_scorer_matches_jax(case, which, tmp_path, monkeypatch):
    crit, jcrit, f, jf, x, p, val = _hold_scorer(case, which, tmp_path, monkeypatch)
    if "norm" in which:
        assert np.isfinite(val).all()
    else:
        # the untransducible target and the zero-length target score NEG;
        # the empty target at length 0 its empty path
        assert (val[[0, 1, 2]] > -1e3).all() and (val[[3]] < -1e29).all()
    if which == "dst_exp_lowrank":
        # the low-rank closure is the dense one
        fn_dense, _ = _functions(crit, jcrit, f, jf, "dst_exp")
        dense = fn_dense(torch.from_numpy(p), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(val, dense, **LOSS_TOL)


@pytest.mark.parametrize("case,which", [("trigram", "dense_score"),
                                        ("unigram_backoff", "dense_score"),
                                        ("unigram_backoff", "dst_staged"),
                                        ("unigram_backoff", "dst_exp")])
def test_scorer_underflow_matches_jax(case, which, tmp_path, monkeypatch):
    """Logits of 40 nats a unit: some states' sums fall below the least
    normal float32, which JAX's devices flush to zero.  The port treats
    such a sum as dead too (kept, the floor of the log would lift it to
    e^-85 of its shift, a frame at a time)."""
    _hold_scorer(case, which, tmp_path, monkeypatch, scale=40.0)


@pytest.mark.parametrize("case", CASES)
def test_transition_matrices_match_jax(case, tmp_path):
    """The factored matrices from the learnable weights: T_exp, t_shift,
    E_exp, e_shift (dense); W_adv_exp, D_exp_t, P_dst (dst); the low-rank
    closure's U and C."""
    crit, jcrit = _pair(case, tmp_path)
    p = (np.random.RandomState(5).randn(crit.num_transition_arcs) * 0.7).astype(np.float32)
    w_eff, ew_eff = crit._eff_weights(torch.from_numpy(p))
    np.testing.assert_allclose(ew_eff.numpy(), jcrit._eps_eff_weights(jnp.asarray(p)),
                               rtol=0, atol=0)
    got = [crit._transition_matrices(w_eff, ew_eff)]
    want = [jcrit._transition_matrices(jnp.asarray(p), crit.num_channels)]
    if crit._factored_backoff_dst:
        got.append(crit._transition_matrices_dst(w_eff, ew_eff))
        want.append(jcrit._transition_matrices_dst(jnp.asarray(p), crit.num_channels))
        got.append(factored.eps_lowrank_build(
            ew_eff, crit._factored_tables(torch.device("cpu"))["eps_lr"]))
        want.append(jax_fact.eps_lowrank_build(jcrit._eps_eff_weights(jnp.asarray(p)),
                                               jcrit._eps_lr_struct))
        np.testing.assert_array_equal(crit._dst_onehot, jcrit._dst_onehot)
    for mats, jmats in zip(got, want):
        assert len(mats) == len(jmats)
        for a, b in zip(mats, jmats):
            if isinstance(b, int):
                assert a == b
            else:
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=0)


def _eps_arrays(crit):
    nt = crit._norm_table
    return nt.eps_src.numpy(), nt.eps_dst.numpy(), nt.start.shape[0], nt.eps_depth


def _fan(n, s):
    """n epsilon arcs out of state 0 into distinct states of s."""
    return np.zeros(n, np.int32), np.arange(1, n + 1, dtype=np.int32), s, 1


EPS_STRUCTS = {
    "no_eps_arcs": lambda tmp: (np.zeros(0, np.int32), np.zeros(0, np.int32), 5, 1),
    "depth_0": lambda tmp: (np.asarray([1]), np.asarray([0]), 5, 0),
    "too_many_paths": lambda tmp: _fan(33, 80),
    "no_win": lambda tmp: (np.asarray([0, 1, 2]), np.asarray([1, 2, 3]), 5, 2),
    **{case: (lambda tmp, case=case: _eps_arrays(_pair(case, tmp)[0])) for case in CASES},
}


@pytest.mark.parametrize("name", list(EPS_STRUCTS))
def test_eps_chain_struct_matches_jax(name, tmp_path):
    """The host structure of the low-rank closure equals JAX's exactly, its
    three None exits included (no epsilon arcs or depth 0; a state with
    more than 32 paths; 2K > S, no win)."""
    args = EPS_STRUCTS[name](tmp_path)
    got, want = factored.eps_chain_struct(*args), jax_fact.eps_chain_struct(*args)
    if name in ("no_eps_arcs", "depth_0", "too_many_paths", "no_win"):
        assert got is None and want is None
        return
    assert got is not None and want is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 3])
def test_ctx_closure_matches_jax(depth):
    """The log-domain epsilon closure along the context axis: values and
    gradients to the scores and the epsilon matrix, with dead entries."""
    rng = np.random.RandomState(depth)
    S = 7
    x = rng.randn(3, 2, S).astype(np.float32)
    x[0, 1] = -1e30
    x[1, 0, :3] = -1e30
    E = np.where(rng.rand(S, S) < 0.4, np.exp(rng.randn(S, S) - 1), 0).astype(np.float32)
    shift = np.float32(0.25)
    g = rng.randn(3, 2, S).astype(np.float32)
    j_val, vjp = jax.vjp(lambda x, E: jax_fact._ctx_closure(x, E, shift, depth),
                         jnp.asarray(x), jnp.asarray(E))
    j_gx, j_gE = vjp(jnp.asarray(g))
    x_t = torch.from_numpy(x).requires_grad_(True)
    E_t = torch.from_numpy(E).requires_grad_(True)
    val = factored._ctx_closure(x_t, E_t, torch.tensor(shift), depth)
    gx, gE = torch.autograd.grad((val * torch.from_numpy(g)).sum(), [x_t, E_t])
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(j_val), **LOSS_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), **GRAD_TOL)
    np.testing.assert_allclose(gE.numpy(), np.asarray(j_gE), **GRAD_TOL)


def test_products_run_without_tf32(monkeypatch, tmp_path):
    """Every product of the scorers, forward and backward, runs with TF32
    off whatever the global flag says, and the flag is restored after."""
    crit, jcrit = _pair("bigram", tmp_path)
    f, jf, x, p = _batch(crit, jcrit, monkeypatch)
    seen = []
    matmul = torch.matmul

    def record(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", record)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for which in ("dense_score", "dst_exp_lowrank", "dst_norm"):
        fn, _ = _functions(crit, jcrit, f, jf, which)
        p_t = torch.from_numpy(p).requires_grad_(True)
        fn(p_t, torch.from_numpy(x)).sum().backward()
    assert len(seen) > 10 and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


DECODE_CASES = [c for c in CASES if c != "trigram"]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_backoff_dst_viterbi_matches_jax(case, tmp_path):
    """The destination-factored decode on each case's matrices: labels
    exactly (-1 past each input length, a zero-length sample all -1),
    scores within 1e-5; integer emissions make exact ties, which both
    break toward the lowest context and label."""
    crit, jcrit = _pair(case, tmp_path)
    rng = np.random.RandomState(9)
    w = (rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32)
    mats = crit._decode_matrices_dst({"transitions": torch.from_numpy(w)},
                                     torch.device("cpu"))
    jmats = jcrit._decode_matrices_dst(w)
    for a, b in zip(mats, jmats):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    B, N = 4, crit.num_channels
    lens = np.asarray([12, 7, 1, 0], np.int32)
    for x in (rng.randn(B, 12, N).astype(np.float32),
              rng.randint(-2, 2, (B, 12, N)).astype(np.float32)):
        labels, score = factored.backoff_dst_viterbi(torch.from_numpy(x), *mats,
                                                     torch.from_numpy(lens))
        jlabels, jscore = jax_fact.backoff_dst_viterbi(jnp.asarray(x), *jmats,
                                                       jnp.asarray(lens))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5, atol=1e-5)
        assert (labels.numpy()[1, 7:] == -1).all() and (labels.numpy()[3] == -1).all()
        assert (labels.numpy()[0] >= 0).all()


@pytest.mark.parametrize("blank", ["optional", "forced", "none"])
def test_factored_decode_matches_composed(blank, monkeypatch):
    """The port's destination-factored decode against its own composed
    decode (the epsilon-removed table and ``viterbi_batch``): the same
    alignment labels, so the same transduced outputs, over random emissions
    and ragged lengths, in every blank mode (JAX's
    ``test_backoff_dst_viterbi_matches_composed``)."""
    toks = [str(i) for i in range(4)]
    g = bt.build_from_lines(_bigram_lines(11), toks, [0, 0], blank, self_loops=True)
    crit = td.Transducer(toks, {t: i for i, t in enumerate(toks)}, transitions=g,
                         blank=blank)
    assert crit._factored_backoff_dst
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(3, 8, crit.num_channels).astype(np.float32))
    lens = torch.tensor([8, 5, 1], dtype=torch.int32)
    params = {"transitions": torch.from_numpy(
        (rng.randn(crit.num_transition_arcs) * 0.4).astype(np.float32))}
    monkeypatch.setattr(td, "_DECODE_FACTORED_MIN_ARCS", 1 << 60)
    ref_labels = crit.viterbi_dispatch(x, params, lens)[0]
    ref = crit.viterbi(x, params, lens)
    monkeypatch.setattr(td, "_DECODE_FACTORED_MIN_ARCS", 0)
    labels = crit.viterbi_dispatch(x, params, lens)[0]
    got = crit.viterbi(x, params, lens)
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    assert [a.tolist() for a in got] == [b.tolist() for b in ref]
    # random emissions rarely give a forced-blank alignment
    assert blank == "forced" or any(len(a) for a in got)


@pytest.mark.parametrize("vjp", ["auto", "off"])
def test_dst_loss_matches_jax(vjp, tmp_path, monkeypatch):
    """The Transducer's dst route (the dense variant refused, as for a
    1k-wordpiece LM) under each ``GTN_FACTORED_VJP`` setting on both sides:
    the exp-linear tier with the low-rank closure, or the staged form; and
    one loss whose batch mixes every kind of sample above."""
    crit, jcrit = _pair("deep_chain", tmp_path)
    for c in (crit, jcrit):
        c._factored_backoff = False
    monkeypatch.setattr(factored, "_VJP_IMPL", vjp)
    monkeypatch.setattr(jax_fact, "_VJP_IMPL", vjp)
    _, _, x, p = _batch(crit, jcrit, monkeypatch, seed=3)
    prep, jprep = crit.prepare(TARGETS), jcrit.prepare(TARGETS)
    assert "factored_dst" in prep and "factored_dst" in jprep
    j_loss, (j_gp, j_gx) = jax.value_and_grad(
        lambda p, x: jcrit.loss({"transitions": p}, x, jprep, jnp.asarray(LENS)),
        argnums=(0, 1))(jnp.asarray(p), jnp.asarray(x))
    p_t = torch.from_numpy(p).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss({"transitions": p_t}, x_t, prep, torch.from_numpy(LENS))
    gx, gp = torch.autograd.grad(loss, [x_t, p_t])
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), **GRAD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(j_gp), **GRAD_TOL)


def test_routes(tmp_path, monkeypatch):
    """``GTN_TRANSDUCER_FACTORED``: under auto the port composes a loaded
    graph on every device (JAX factors it only on the TPU) and factors the
    bigram; on factors the loaded graph; off composes both."""
    crit, _ = _pair("bigram", tmp_path)
    bigram = td.Transducer(["a", "b"], {"a": 0, "b": 1}, ngram=2, blank="optional")
    for impl, loaded, full in (("auto", "table", "factored"), ("on", "factored", "factored"),
                               ("off", "table", "table"), ("step", "table", "table")):
        monkeypatch.setattr(td, "_FACTORED_IMPL", impl)
        assert loaded in crit.prepare(TARGETS), impl
        assert full in bigram.prepare([[0, 1], [1]]), impl
