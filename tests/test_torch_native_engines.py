"""The port's six batched graph engines (``wfst/native.py``) against the
JAX package's and against the port's criteria on the CPU.

Each engine binds the same symbol of ``native/graph_compiler.cc`` as JAX's,
so on the same numpy inputs (made from a seed) its losses and gradients
equal JAX's bitwise and its decodes exactly.  Against the port's own
criteria the engines hold JAX's tolerances (``tests/test_native.py``):
losses rtol 1e-5 (+ atol 1e-5 per sample), gradients rtol 1e-4 + atol
1e-5, decodes exactly.
"""

import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu.wfst import native as jnative
from gtn_applications_tpu_torch.criterions import STC
from gtn_applications_tpu_torch.criterions import transducer as td
from gtn_applications_tpu_torch.criterions.common import pad_targets
from gtn_applications_tpu_torch.criterions.stc import (
    _STAR_SENTINEL, STC_BLANK_IDX, make_stc_graph,
)
from gtn_applications_tpu_torch.ops import lattice
from gtn_applications_tpu_torch.wfst import native

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _log_softmax(rng, shape):
    return torch.log_softmax(torch.from_numpy(rng.randn(*shape).astype(np.float32)),
                             2).numpy()


def _bitwise(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _ctc_case():
    rng = np.random.RandomState(0)
    B, T, C = 5, 14, 7
    lp = _log_softmax(rng, (B, T, C))
    targets = [rng.randint(0, C - 1, size=rng.randint(1, 7)).tolist() for _ in range(B - 1)]
    targets.append([2, 2, 3, 3])  # repeats take the no-skip rule
    return lp, targets, C - 1


def test_ctc_engine_matches_jax_and_lattice():
    lp, targets, blank = _ctc_case()
    got = native.ctc_engine_batch(lp, targets, blank)
    _bitwise(got, jnative.ctc_engine_batch(lp, targets, blank))
    losses, grad = got
    tg, ln = pad_targets(targets)
    x = torch.from_numpy(lp).requires_grad_(True)
    score = lattice.ctc_forward_score(x, tg, ln, blank, impl="scan")
    (-score.sum()).backward()
    np.testing.assert_allclose(losses, -score.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, x.grad.numpy(), **GRAD_TOL)


def test_ctc_engine_golden_and_impossible_target():
    golden = np.log(np.array([
        [0.633766, 0.221185, 0.0917319, 0.0129757, 0.0142857, 0.0260553],
        [0.111121, 0.588392, 0.278779, 0.0055756, 0.00569609, 0.010436],
        [0.0357786, 0.633813, 0.321418, 0.00249248, 0.00272882, 0.0037688],
        [0.0663296, 0.643849, 0.280111, 0.00283995, 0.0035545, 0.00331533],
        [0.458235, 0.396634, 0.123377, 0.00648837, 0.00903441, 0.00623107],
    ], dtype=np.float32))[None]
    losses, grad = native.ctc_engine_batch(golden, [[0, 1, 2, 1, 0]], blank=5)
    assert abs(losses[0] - 3.34211) < 1e-4
    assert abs(grad.sum() + golden.shape[1]) < 1e-3
    with pytest.raises(ValueError, match="no accepting CTC path"):
        native.ctc_engine_batch(np.zeros((1, 3, 4), np.float32), [[0, 1, 0, 1, 0]], 3)


def test_asg_engine_matches_jax_and_lattice():
    rng = np.random.RandomState(1)
    B, T, C = 4, 12, 6
    lp = rng.randn(B, T, C).astype(np.float32)
    trans = (rng.randn(C + 1, C) * 0.3).astype(np.float32)
    targets = [rng.randint(0, C, size=rng.randint(1, 6)).tolist() for _ in range(B)]
    got = native.asg_engine_batch(lp, targets, trans)
    _bitwise(got, jnative.asg_engine_batch(lp, targets, trans))
    losses, g_em, g_tr = got
    tg, ln = pad_targets(targets)
    x = torch.from_numpy(lp).requires_grad_(True)
    w = torch.from_numpy(trans).requires_grad_(True)
    per_sample = lattice.asg_fcc_score(x, w) - lattice.asg_fal_score(x, w, tg, ln)
    per_sample.sum().backward()
    np.testing.assert_allclose(losses, per_sample.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_em, x.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(g_tr, w.grad.numpy(), **GRAD_TOL)


def _transducer_check(kind, rng):
    """(port criterion, JAX criterion, targets, B, T, C) of the
    transitions-free cases of JAX's engine test."""
    kw = dict(blank="optional", allow_repeats=False, reduction="none")
    if kind == "singletons":
        args = ([(i,) for i in range(7)], {i: i for i in range(7)})
        targets = [rng.randint(0, 7, size=rng.randint(1, 5)).tolist() for _ in range(3)]
        return td.Transducer(*args, **kw), jax_td.Transducer(*args, **kw), targets, 3, 10, 8
    args = (["a", "b", "ab", "ba"], {"a": 0, "b": 1})
    return (td.Transducer(*args, **kw), jax_td.Transducer(*args, **kw),
            [[0, 1, 0], [1, 1]], 2, 8, 5)


@pytest.mark.parametrize("kind", ["singletons", "decompositions"])
def test_transducer_engine_matches_jax_and_criterion(kind):
    rng = np.random.RandomState(0)
    crit, jcrit, targets, B, T, C = _transducer_check(kind, rng)
    x = rng.randn(B, T, C).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(x), 2).numpy()
    got = native.transducer_engine_batch(lp, crit.lexicon, crit.tokens, targets)
    _bitwise(got, jnative.transducer_engine_batch(lp, jcrit.lexicon, jcrit.tokens, targets))
    losses, grad = got
    prep = crit.prepare(targets)
    np.testing.assert_allclose(losses.mean(), float(crit.loss({}, torch.from_numpy(lp), prep)),
                               rtol=1e-5)
    x_t = torch.from_numpy(x).requires_grad_(True)
    (crit.loss({}, x_t, prep) * B).backward()
    chained = grad - np.exp(lp) * grad.sum(-1, keepdims=True)
    np.testing.assert_allclose(chained, x_t.grad.numpy(), **GRAD_TOL)


def test_transducer_ngram_engine_matches_jax_and_criterion():
    N, T, L, B = 8, 20, 5, 3
    rng = np.random.RandomState(0)
    args = ([(i,) for i in range(N)], {i: i for i in range(N)})
    crit = td.Transducer(*args, ngram=2, reduction="none")
    jcrit = jax_td.Transducer(*args, ngram=2, reduction="none")
    x = rng.randn(B, T, N).astype(np.float32)
    targets = [rng.randint(0, N, size=L).tolist() for _ in range(B)]
    got = native.transducer_ngram_engine_batch(x, crit.lexicon, crit.tokens,
                                               crit.transitions, targets)
    _bitwise(got, jnative.transducer_ngram_engine_batch(
        x, jcrit.lexicon, jcrit.tokens, jcrit.transitions, targets))
    losses, g_em, g_tr = got
    params = {"transitions": torch.zeros(crit.num_transition_arcs, requires_grad=True)}
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss(params, x_t, crit.prepare(targets))
    loss.backward()
    np.testing.assert_allclose(losses.mean(), float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(x_t.grad.numpy(), g_em / B, **GRAD_TOL)
    # the criterion's parameter layout and the graph's arc order differ:
    # compare as sorted multisets
    np.testing.assert_allclose(np.sort(params["transitions"].grad.numpy()),
                               np.sort(g_tr / B), **GRAD_TOL)


def test_acceptor_engine_matches_jax_and_stc():
    Ns, Ts, Ls, Bs = 10, 30, 6, 3
    rng = np.random.RandomState(0)
    crit = STC(0, p0=1.0, plast=0.1, thalf=100, reduction="none", shift_targets=1)
    xs = rng.randn(Bs, Ts, Ns + 1).astype(np.float32)
    raw = [rng.randint(0, Ns, size=Ls).tolist() for _ in range(Bs)]
    prep = crit.prepare(raw)
    x_t = torch.from_numpy(xs).requires_grad_(True)
    loss = crit.loss({}, x_t, prep)
    loss.backward()

    em_t = crit.star_channels(torch.log_softmax(x_t, 2), prep["select"])
    em = em_t.detach().numpy()
    targets = [[t + 1 for t in tgt] for tgt in raw]
    select = [STC_BLANK_IDX] + sorted(set(t for tgt in targets for t in tgt))
    tmap = {t: i for i, t in enumerate(select)}
    Csel = ((len(select) + 7) // 8) * 8
    graphs = []
    for tgt in targets:
        g = make_stc_graph([tmap[t] for t in tgt], Csel)
        g.arc_weight = [prep["log_penalty"] if w == _STAR_SENTINEL else w
                        for w in g.arc_weight]
        graphs.append(g)
    got = native.acceptor_engine_batch(em, graphs)
    _bitwise(got, jnative.acceptor_engine_batch(em, graphs))
    losses, grad_em = got
    np.testing.assert_allclose(losses.mean(), float(loss.detach()), rtol=1e-5)
    (gx,) = torch.autograd.grad(em_t, x_t, torch.from_numpy(grad_em / Bs))
    np.testing.assert_allclose(x_t.grad.numpy(), gx.numpy(), **GRAD_TOL)


def test_transducer_viterbi_batch_matches_jax_and_criterion():
    tokens = ["a", "b", "ab", "ba", "c"]
    g2i = {c: i for i, c in enumerate("abc")}
    crit = td.Transducer(tokens, g2i, blank="optional", allow_repeats=False)
    B, T, C = 6, 14, len(tokens) + 1
    x = np.random.RandomState(3).randn(B, T, C).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(x), 2).numpy()
    got = native.transducer_viterbi_batch(lp, crit.tokens)
    assert got == jnative.transducer_viterbi_batch(lp, crit.tokens)
    want = crit.viterbi(torch.from_numpy(x))
    assert got == [w.tolist() for w in want]
    assert any(got)


def test_engines_raise_where_no_path():
    with pytest.raises(ValueError, match="no accepting path"):
        native.acceptor_engine_batch(np.zeros((1, 2, 3), np.float32),
                                     [make_stc_graph([1, 2, 1, 2], 8)])
