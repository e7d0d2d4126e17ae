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

The kernels run only on the card, where ``chip_smoke.py`` holds them
against these plain versions; here that check is itself tested, with the
plain versions standing in for the kernels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import sparse as jax_sparse
from gtn_applications_tpu.ops import viterbi_scan_pallas as jax_vsp
from gtn_applications_tpu.ops.sparse import ArcTable as JaxArcTable
from gtn_applications_tpu_torch.ops import sparse
from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
from gtn_applications_tpu_torch.ops.semiring import NEG
from gtn_applications_tpu_torch.ops.sparse import ArcTable


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
    port, _ = _tables([0], [1], [0], [0.0], [0.0, NEG], [NEG, 0.0])
    em = torch.zeros(1, 2, 2)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        sparse.viterbi_batch(em, dataclasses.replace(
            port, eps_src=torch.zeros(1, dtype=torch.int32),
            eps_dst=torch.ones(1, dtype=torch.int32),
            eps_weight=torch.zeros(1), eps_depth=1))
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        sparse.viterbi_batch(em, dataclasses.replace(port, src=port.src[None]))
    dead = dataclasses.replace(port, weight=torch.full((1,), NEG))  # padding only: no plan
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        sparse.viterbi_batch(em, dead)


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
