"""The port's whole-scan Viterbi against the JAX package.

``build_plan`` of both packages on the same numpy-seeded arc tables must
give the same in-degree bucket layout (JAX pads the states to 128 lanes;
the port does not).  The port's ``viterbi_scan`` (its plain versions, as
CPU tensors take them) against JAX ``viterbi_scan_pallas.viterbi_scan``
(its Pallas kernels in interpret mode off-TPU): labels exactly equal,
scores within 1e-5.  The cases follow ``tests/test_viterbi_scan.py``:
uniform and skewed in-degree, ragged lengths, an infeasible sample and an
exact tie.  JAX's per-step oracle ``sparse.viterbi`` breaks ties within
1e-6 of the best, the whole scan on the exact maximum; the port follows
the whole scan, so it is held to the oracle only on data with no near
ties (random normal emissions).

The per-step decode (``viterbi_batch``'s route for a table the bucket
plan refuses) against JAX's ``_viterbi_batched_pallas`` (its ``seg_max``
in interpret mode), and the port's ``viterbi`` against JAX's per-sample
oracle under ``vmap``: labels exactly, scores within 1e-6, on JAX's own
test table (``tests/test_seglse.py``, compiled by both packages'
``compile_acceptor(semiring="tropical", remove_eps=True)``) and on an
unpruned grapheme 4-gram's decode table, which the plan refuses; with
ragged lengths, T = 1 and an infeasible sample.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against these plain versions; here that check is itself tested, with the
plain versions standing in for the kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import wfst as jax_wfst
from gtn_applications_tpu.ops import sparse as jax_sparse
from gtn_applications_tpu.ops import viterbi_scan_pallas as jax_vsp
from gtn_applications_tpu.ops.sparse import ArcTable as JaxArcTable
from gtn_applications_tpu_torch.ops import sparse
from gtn_applications_tpu_torch import wfst
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
from gtn_applications_tpu_torch.ops.semiring import NEG
from gtn_applications_tpu_torch.ops.sparse import ArcTable
from gtn_applications_tpu_torch.scripts.build_transitions import grapheme_lm


def _tables(src, dst, label, w, start, accept):
    """The same arc table for both packages."""
    z = np.zeros((0,), np.int32)
    fields = [np.asarray(a, dt) for a, dt in (
        (src, np.int32), (dst, np.int32), (label, np.int32), (w, np.float32),
        (start, np.float32), (accept, np.float32))]
    port = ArcTable(*[torch.from_numpy(a) for a in fields],
                    torch.from_numpy(z), torch.from_numpy(z),
                    torch.zeros(0), eps_depth=0)
    ref = JaxArcTable(*[jnp.asarray(a) for a in fields], jnp.asarray(z),
                      jnp.asarray(z), jnp.zeros((0,), jnp.float32), eps_depth=0)
    return port, ref


def _random_table(S, A, C, rng, skew=False):
    """A chain through every state plus random arcs (half of them into
    state 0 when ``skew``), start at 0 and accept at S-1."""
    src, dst = list(range(S - 1)), list(range(1, S))
    while len(src) < A - 2:
        src.append(int(rng.integers(0, S)))
        dst.append(0 if skew and rng.random() < 0.5 else int(rng.integers(0, S)))
    src += [0, S - 1]
    dst += [0, S - 1]
    label = rng.integers(0, C, size=len(src))
    w = rng.normal(size=len(src)) * 0.5
    start = np.full((S,), NEG)
    start[0] = 0.0
    accept = np.full((S,), NEG)
    accept[S - 1] = 0.0
    return _tables(src, dst, label, w, start, accept)


def _decode_both(port, ref, em, lens):
    plan, jplan = vsp.build_plan(port), jax_vsp.build_plan(ref)
    assert plan is not None and jplan is not None
    labels, score = vsp.viterbi_scan(torch.from_numpy(em), plan,
                                     torch.from_numpy(lens))
    j_labels, j_score = jax_vsp.viterbi_scan(jnp.asarray(em), jplan,
                                             jnp.asarray(lens))
    return labels.numpy(), score.numpy(), np.asarray(j_labels), np.asarray(j_score)


@pytest.mark.parametrize("skew", [False, True])
def test_plan_matches_jax(skew):
    rng = np.random.default_rng(3 + skew)
    port, ref = _random_table(9, 28, 5, rng, skew)
    plan, jplan = vsp.build_plan(port), jax_vsp.build_plan(ref)
    S = 9
    assert (plan.D, plan.S) == (jplan.D, S)
    for mine, theirs in ((plan.src_bucket, jplan.src_bucket),
                         (plan.label_bucket, jplan.label_bucket),
                         (plan.w_bucket, jplan.w_bucket)):
        np.testing.assert_array_equal(
            mine.numpy(), np.asarray(theirs).reshape(jplan.D, jplan.S_pad)[:, :S])
    np.testing.assert_array_equal(plan.start.numpy(), np.asarray(jplan.start_p)[:S])
    assert vsp.build_plan(port) is plan                  # cached by identity
    assert vsp.build_plan(dataclasses.replace(port, weight=port.weight + 1.0)) is not plan


@pytest.mark.parametrize("skew", [False, True])
def test_viterbi_scan_matches_jax_kernel(skew):
    rng = np.random.default_rng(3 + skew)
    B, T, S, A, C = 5, 12, 9, 28, 5
    port, ref = _random_table(S, A, C, rng, skew)
    em = rng.normal(size=(B, T, C)).astype(np.float32)
    lens = np.asarray([T, T - 1, T - 4, 3, 1], np.int32)
    labels, score, j_labels, j_score = _decode_both(port, ref, em, lens)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_allclose(score, j_score, rtol=1e-5, atol=1e-5)
    # and the per-step oracle, on data without near ties
    for b in range(B):
        o_lab, o_score = jax_sparse.viterbi(jnp.asarray(em[b]), ref, int(lens[b]))
        np.testing.assert_array_equal(labels[b], np.asarray(o_lab))
        assert abs(float(score[b]) - float(o_score)) < 1e-4


def test_infeasible_sample_decodes_empty():
    # a 3-state chain needing exactly 2 frames to accept: length 1 is
    # infeasible
    port, ref = _tables([0, 1], [1, 2], [0, 1], [0.0, 0.0], [0.0, NEG, NEG],
                        [NEG, NEG, 0.0])
    em = np.random.default_rng(0).normal(size=(3, 2, 3)).astype(np.float32)
    lens = np.asarray([2, 1, 2], np.int32)
    labels, score, j_labels, j_score = _decode_both(port, ref, em, lens)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_array_equal(labels, [[0, 1], [-1, -1], [0, 1]])
    assert score[1] < NEG / 2 and j_score[1] < NEG / 2


def test_exact_tie_takes_the_lowest_arc():
    # two paths of equal score into state 3: the lower arc id wins
    port, ref = _tables([0, 0, 1, 2], [1, 2, 3, 3], [0, 1, 2, 2], [0.0] * 4,
                        [0.0, NEG, NEG, NEG], [NEG, NEG, NEG, 0.0])
    em = np.zeros((1, 2, 3), np.float32)
    labels, score, j_labels, j_score = _decode_both(port, ref, em,
                                                    np.asarray([2], np.int32))
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_array_equal(labels, [[0, 2]])
    assert score[0] == j_score[0]


def test_viterbi_batch_refuses_what_is_not_ported():
    """A table with epsilon arcs and one with per-sample fields raise
    ``ValueError`` (JAX decodes only shared epsilon-free tables); a table
    the bucket plan refuses (here: padding arcs only) takes the per-step
    decode, in which no path accepts."""
    port, _ = _tables([0], [1], [0], [0.0], [0.0, NEG], [NEG, 0.0])
    em = torch.zeros(2, 2, 2)
    with pytest.raises(ValueError, match="epsilon-free"):
        sparse.viterbi_batch(em, dataclasses.replace(
            port, eps_src=torch.zeros(1, dtype=torch.int32),
            eps_dst=torch.ones(1, dtype=torch.int32),
            eps_weight=torch.zeros(1), eps_depth=1))
    with pytest.raises(ValueError, match="per-sample"):
        sparse.viterbi_batch(em, dataclasses.replace(port, src=port.src[None]))
    dead = dataclasses.replace(port, weight=torch.full((1,), NEG))  # padding only: no plan
    assert vsp.build_plan(dead) is None
    labels, score = sparse.viterbi_batch(em, dead)
    assert labels.tolist() == [[-1, -1], [-1, -1]] and bool((score <= NEG / 2).all())


def _seglse_test_graph(module):
    """The graph of JAX's ``test_viterbi_batched_pallas_matches_vmap``
    (``tests/test_seglse.py``), built with ``module``'s ``Graph``."""
    rng = np.random.RandomState(5)
    g = module.Graph()
    for i in range(6):
        g.add_node(i == 0, i >= 4)
    for _ in range(14):
        s = rng.randint(0, 5)
        d = rng.randint(s, 6)
        lbl = rng.randint(0, 4)
        g.add_arc(s, min(d, 5), lbl, lbl, float(rng.randn() * 0.3))
    for i in range(6):
        g.add_arc(i, i, rng.randint(0, 4), None, float(rng.randn() * 0.3))
    return g


def _step_tables(name):
    """(port table, JAX table, channels) of a step-decode case."""
    if name == "seglse test graph":
        cg = wfst.compile_acceptor(_seglse_test_graph(wfst), semiring="tropical",
                                   remove_eps=True)
        jcg = jax_wfst.compile_acceptor(_seglse_test_graph(jax_wfst),
                                        semiring="tropical", remove_eps=True)
        assert cg._fields == jcg._fields
        for field, a, b in zip(cg._fields, cg, jcg):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
        table = wfst.to_arc_table(cg)
        return table, jax_wfst.to_arc_table(jcg), 4
    # an unpruned grapheme 4-gram over 16 synthetic lines: a hub of in-degree
    # S - 1 blows the bucket grid up past the plan's gate
    pre = synthetic.Preprocessor(None, num_features=16)
    texts = synthetic.Dataset(None, pre, split="train").texts[:16]
    g = grapheme_lm(texts, pre.tokens, (0, 0, 0, 0))
    w = (np.random.RandomState(8).randn(g.num_arcs()) * 0.5).astype(np.float32)
    table = wfst.apply_decode_weights(wfst.build_decode_template(g), w)
    assert vsp.build_plan(table) is None
    fields = [np.asarray(getattr(table, f)) for f in (
        "src", "dst", "label", "weight", "start", "accept", "eps_src", "eps_dst",
        "eps_weight")]
    return table, JaxArcTable(*map(jnp.asarray, fields), eps_depth=0), pre.num_tokens + 1


@pytest.mark.parametrize("T", [9, 1])
@pytest.mark.parametrize("name", ["seglse test graph", "4-gram"])
def test_step_decode_matches_jax(name, T):
    table, jtable, C = _step_tables(name)
    rng = np.random.default_rng(T)
    em = rng.normal(size=(3, T, C)).astype(np.float32)
    lens = np.asarray([T, max(T - 4, 0), T], np.int32)
    em[2, T // 2] = NEG  # an all-NEG frame: sample 2 has no accepting path
    labels, score = sparse._viterbi_batched(torch.from_numpy(em), table,
                                            torch.from_numpy(lens))
    j_labels, j_score = jax_sparse._viterbi_batched_pallas(
        jnp.asarray(em), jtable, jnp.asarray(lens))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=0, atol=1e-6)
    assert labels[2].tolist() == [-1] * T and float(score[2]) <= NEG / 2
    # the per-sample oracles of both packages, on data without near ties
    o_labels, o_score = jax.vmap(lambda e, n: jax_sparse.viterbi(e, jtable, n))(
        jnp.asarray(em), jnp.asarray(lens))
    for b in range(3):
        lab, sc = sparse.viterbi(torch.from_numpy(em[b]), table, int(lens[b]))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(o_labels[b]))
        np.testing.assert_array_equal(lab.numpy(), labels[b].numpy())
        np.testing.assert_allclose(float(sc), float(o_score[b]), rtol=0, atol=1e-6)
    if name == "4-gram":
        routed, _ = sparse.viterbi_batch(torch.from_numpy(em), table, torch.from_numpy(lens))
        assert torch.equal(routed, labels)


@pytest.mark.parametrize("broken", [False, True])
def test_smoke_viterbi_check_holds_slots_bitwise(monkeypatch, broken):
    """``chip_smoke.py``'s check of the Viterbi kernels with the plain
    versions standing in: it passes them as they are and fails one slot
    moved to another bucket."""
    import chip_smoke

    def fwd(*args):
        slots, final = vsp.viterbi_scan_fwd_plain(*args)
        if broken:
            live = (slots < vsp.DEAD).nonzero()
            slots[tuple(live[len(live) // 2])] += 1
        return slots, final

    monkeypatch.setattr(vsp, "viterbi_scan_fwd_cuda", fwd)
    monkeypatch.setattr(vsp, "viterbi_backtrace_cuda", vsp.viterbi_backtrace_plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    inputs = chip_smoke.viterbi_headline_inputs(torch, "cpu", b=4, t=30, n=6)
    if broken:
        with pytest.raises(AssertionError, match="slots"):
            chip_smoke.hold_viterbi_kernels(torch, *inputs, "test")
    else:
        assert chip_smoke.hold_viterbi_kernels(torch, *inputs, "test") == {
            "viterbi_scan_fwd": 0.0, "viterbi_backtrace": 0.0}
