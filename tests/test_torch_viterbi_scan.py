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
plain versions standing in for the kernels.  The kernel's schedule is
emulated in float32 (its lanes, merges and hub parts, and the decode's
walk words and walk, from the block's argmax to one word a frame), held
bitwise to the plain scan and ``viterbi_backtrace_plain``; its host plans
(routes, emission rows and the walk's route) are checked at the decode
headline, the backoff trigram path's decode table and T = 608.
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


@pytest.mark.parametrize("broken", [False, True, "labels"])
def test_smoke_viterbi_check_holds_slots_bitwise(monkeypatch, broken):
    """``chip_smoke.py``'s check of the Viterbi kernel with the plain
    versions standing in (the decode: the plain scan and backtrace): it
    passes them as they are, and fails one slot moved to another bucket or
    one decoded label changed."""
    import chip_smoke

    calls = []

    def fwd(em, src_b, lab_b, w_b, start, lens, packed=None, route=None, accept=None,
            walk=None):
        calls.append((route, walk, accept is not None))
        slots, final = vsp.viterbi_scan_fwd_plain(em, src_b, lab_b, w_b, start, lens)
        if accept is None:
            if broken is True:
                live = (slots < vsp.DEAD).nonzero()
                slots[tuple(live[len(live) // 2])] += 1
            return slots, final
        labels, score = vsp.viterbi_backtrace_plain(slots, final, accept, src_b, lab_b)
        if broken == "labels":
            labels[0, 0] += 1
        return slots, final, labels, score

    monkeypatch.setattr(vsp, "viterbi_scan_fwd_cuda", fwd)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    inputs = chip_smoke.viterbi_headline_inputs(torch, "cpu", b=4, t=30, n=6)
    if broken:
        with pytest.raises(AssertionError, match="slots" if broken is True else "labels"):
            chip_smoke.hold_viterbi_kernels(torch, *inputs, "test")
    else:
        assert chip_smoke.hold_viterbi_kernels(torch, *inputs, "test", routes=vsp.ROUTES,
                                               walks=vsp.WALKS) == {
            "viterbi_scan_fwd": 0.0, "viterbi_backtrace": 0.0}
        # the scan alone by each route, the decode by each walk beside each
        assert calls == [(r, w, a) for r in vsp.ROUTES
                         for w, a in [(None, False)] + [(w, True) for w in vsp.WALKS]]


# ---------------------------------------------------------------------------
# The scan kernel's list by destination and lane schedule, emulated
# ---------------------------------------------------------------------------

INT_MAX = 2**31 - 1
NO_TASK = -2**31


def _read_schedule(words):
    """(slots, tasks, hubs, states of no arcs) of ``lane_schedule``'s
    words."""
    (n_slots, n_tasks, n_hubs, _, slot_off, task_off, hub_off, _, n_empty,
     empty_off) = (int(x) for x in words[:vsp.HEAD])
    row = lambda off, i, k: tuple(int(x) for x in words[off + k * i:off + k * i + k])  # noqa: E731
    return ([row(slot_off, q, 3) for q in range(n_slots)],
            [row(task_off, i, 4) for i in range(n_tasks)],
            [row(hub_off, i, 3) for i in range(n_hubs)],
            [int(x) for x in words[empty_off:empty_off + n_empty]])


def _lanes_of(words, A):
    """Each slot's 32 lanes as the kernel reads them (``lane_task``):
    (g, [(key, position, arcs, slot d)] by lane)."""
    slots, tasks, _, _ = _read_schedule(words)
    out = []
    for g, first, count in slots:
        lanes = []
        for lane in range(32):
            i, sub = divmod(lane, g)
            if i >= count:
                lanes.append((NO_TASK, A, 0, 0))
                continue
            key, pos, n, d0 = tasks[first + i]
            nl = -(-(n - sub) // g) if n > sub else 0
            lanes.append((key, pos + sub if nl else A, nl, d0 + sub))
        out.append((g, lanes))
    return out


def _packed_plan_cases():
    """(name, [D, S] buckets) of the headline plan, the skewed plan of
    ``chip_smoke.py`` and a random plan with an isolated state."""
    import chip_smoke

    head = chip_smoke.viterbi_headline_inputs(torch, "cpu", b=1, t=2)
    skew = chip_smoke.viterbi_skewed_inputs(torch, "cpu", b=2, t=2)
    port, _ = _random_table(9, 28, 5, np.random.default_rng(6))
    isolated = dataclasses.replace(port, dst=torch.where(port.dst == 4, 5, port.dst))
    plan = vsp.build_plan(isolated)
    return [("headline", head[1:4]), ("skewed", skew[1:4]),
            ("isolated state", (plan.src_bucket, plan.label_bucket, plan.w_bucket))]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_packed_list_keeps_every_arcs_slot(case):
    """Every real arc of the [D, S] grid sits in its state's row of the
    list by destination at position row start + d, packed with its source,
    label and weight; the lane schedule reaches every position exactly
    once, each with that d, and gives each state one task, one hub or (an
    isolated state) a place in the list of states of no arcs."""
    name, (src_b, lab_b, w_b) = _packed_plan_cases()[case]
    D, S = src_b.shape
    packed = vsp.pack_buckets(src_b, lab_b, w_b)
    arcs = packed.arcs.numpy()
    real = w_b.numpy() > NEG / 2
    deg = real.sum(0)
    assert packed.A == int(deg.sum()) and arcs.shape == (packed.A + 1, 2)
    assert (packed.S, packed.labels) == (S, int(lab_b.numpy()[real].max()) + 1)
    assert arcs[-1, 0] == 0 and np.isneginf(arcs[-1:, 1].view(np.float32)[0])
    ptr = np.cumsum(deg) - deg
    for d, s in zip(*np.nonzero(real)):
        pk, w = arcs[ptr[s] + d]
        assert (pk & 0xFFFF, pk >> 16) == (src_b[d, s], lab_b[d, s]), (name, d, s)
        assert np.int32(w).view(np.float32) == w_b[d, s]
    seen = {}
    for g, lanes in _lanes_of(packed.sched.numpy(), packed.A):
        for key, pos, nl, d in lanes:
            assert nl <= packed.cap <= vsp.LANE_ARCS
            for j in range(nl):
                p = pos + j * g
                assert p not in seen
                seen[p] = (key, d + j * g)
    _, tasks, hubs, empty = _read_schedule(packed.sched.numpy())
    state_of = {-1 - p: h[0] for h in hubs for p in range(h[1], h[1] + h[2])}
    assert sorted(seen) == list(range(packed.A))
    for p, (key, d) in seen.items():
        s = state_of.get(key, key)
        assert ptr[s] <= p < ptr[s] + deg[s] and p - ptr[s] == d
    keys = [t[0] for t in tasks if t[0] >= 0] + [h[0] for h in hubs] + empty
    assert sorted(keys) == list(range(S))
    assert empty == np.flatnonzero(deg == 0).tolist()
    if name == "isolated state":
        assert deg[4] == 0 and 4 in empty


def test_pack_refuses_what_does_not_fit_16_bits():
    """S or a label of 2^16 or more raises: the kernel packs both in one
    word."""
    z = torch.zeros(1, 2**16, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^16"):
        vsp.pack_buckets(z, z, torch.zeros(1, 2**16))
    lab = torch.tensor([[2**16, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^16"):
        vsp.pack_buckets(torch.zeros_like(lab), lab, torch.zeros(1, 2))
    with pytest.raises(ValueError, match="outside"):
        vsp.pack_buckets(torch.full_like(lab, 2), torch.zeros_like(lab), torch.zeros(1, 2))


def _merge(x, y, ties):
    """The kernel's merge of (value, slot): greater value, else lower slot;
    counts the exact ties above NEG between different slots."""
    if x[0] == y[0] and x[0] > NEG and x[1] != y[1]:
        ties[0] += 1
    return x if (x[0] > y[0] or (x[0] == y[0] and x[1] < y[1])) else y


def _emulate_scan(packed, em, lens, start, S):
    """``viterbi_scan_fwd_kernel`` on ``packed``, in float32: each slot's
    lanes (a strict > over the kernel's rounds, a round past a lane's arcs
    at weight -inf, the packed word of the lane's best arc), the xor
    shuffles of each group and the word from the lane that holds the
    winning slot (d mod g), the hubs' parts merged in order after the
    barrier, the states of no arcs NEG.  (slots, final, walk words, ties
    across lanes, ties across a hub's chunks); a DEAD slot's word is its
    state | DEAD_LABEL << 16, frames past the length have none (-1)."""
    f32 = np.float32
    arcs = packed.arcs.numpy()
    packed_w = arcs[:, 0].view(np.uint32)
    src, lab = arcs[:, 0] & 0xFFFF, (packed_w >> 16).astype(np.int64)
    w = arcs[:, 1].view(np.float32)
    words = packed.sched.numpy()
    lanes = _lanes_of(words, packed.A)
    _, _, hubs, empty = _read_schedule(words)
    rounds = vsp.LANE_ARCS
    B, T, _ = em.shape
    slots = np.full((B, T, S), vsp.DEAD, np.int32)
    walk = np.full((B, T, S), -1, np.int64)
    final = np.empty((B, S), np.float32)
    lane_ties, hub_ties = [0], [0]
    for b in range(B):
        alpha = start.copy()
        for t in range(min(max(int(lens[b]), 0), T)):
            new = np.full(S, np.nan, np.float32)
            parts = {}

            def emit(s, v, d, word):
                assert np.isnan(new[s])  # every state once a frame
                new[s] = max(v, f32(NEG))
                live = new[s] > f32(NEG)
                slots[b, t, s] = d if live else vsp.DEAD  # noqa: B023
                walk[b, t, s] = word if live else s | vsp.DEAD_LABEL << 16  # noqa: B023

            for g, slot_lanes in lanes:
                vals, own = [], []
                for key, pos, nl, d in slot_lanes:
                    best, bj, word = f32(-np.inf), rounds, 0
                    for j in range(rounds):
                        p = pos + j * g if j < nl else pos
                        wj = w[p] if j < nl else f32(-np.inf)
                        c = f32(f32(alpha[src[p]] + wj) + em[b, t, lab[p]])
                        if c > best:
                            best, bj, word = c, j, int(packed_w[p])
                    vals.append((best, d + bj * g if bj < rounds else INT_MAX))
                    own.append(word)
                off = g // 2
                while off:
                    vals = [_merge(vals[i], vals[i ^ off], lane_ties) for i in range(32)]
                    off //= 2
                for i in range(0, 32, g):
                    key = slot_lanes[i][0]
                    word = own[i | (vals[i][1] & (g - 1))]
                    if key >= 0:
                        emit(key, *vals[i], word)
                    elif key != NO_TASK:
                        parts[-1 - key] = vals[i] + (word,)
            for s in empty:
                emit(s, f32(-np.inf), INT_MAX, 0)
            for s, p0, n in hubs:
                m = (f32(-np.inf), INT_MAX, 0)
                for p in range(p0, p0 + n):
                    m = _merge(m, parts[p], hub_ties)
                emit(s, *m)
            assert not np.isnan(new).any()
            alpha = new
        final[b] = alpha
    return slots, final, walk, lane_ties[0], hub_ties[0]


def _emulate_walk(walk, final, accept, lens, threads):
    """The kernel's walk tail, in float32: the first argmax of final +
    accept by ``threads`` threads (each a strict > over its states
    s = thread, thread + threads, ...), their warps' xor merges and the
    block's merge under "greater, else lower state"; then from the last
    live frame down one word a frame (label the high half, -1 for
    DEAD_LABEL, the next state the low half), -1 past the length and on a
    sample whose score is <= NEG / 2.  (labels, score, argmax ties, DEAD
    words walked)."""
    B, T, S = walk.shape
    labels = np.full((B, T), -1, np.int32)
    score = np.empty(B, np.float32)
    ties, dead = [0], 0
    for b in range(B):
        x = (final[b] + accept).astype(np.float32)
        own = []
        for i in range(threads):
            v, arg = np.float32(-np.inf), INT_MAX
            for s in range(i, S, threads):
                if x[s] > v:
                    v, arg = x[s], s
            own.append((v, arg))
        warps = []
        for w0 in range(0, threads, 32):
            vals = own[w0:w0 + 32]
            off = 16
            while off:
                vals = [_merge(vals[i], vals[i ^ off], ties) for i in range(32)]
                off //= 2
            warps.append(vals[0])
        best = (np.float32(-np.inf), INT_MAX)
        for v in warps:
            best = _merge(best, v, ties)
        score[b], state = best
        if best[0] <= np.float32(NEG / 2):
            continue
        for t in reversed(range(min(max(int(lens[b]), 0), T))):
            word = int(walk[b, t, state])
            label, state = word >> 16, word & 0xFFFF
            dead += label == vsp.DEAD_LABEL
            labels[b, t] = -1 if label == vsp.DEAD_LABEL else label
    return labels, score, ties[0], dead


def _tie_table(S=24, seed=40):
    """A plan over S states with a hub (state 0, in-degree 150), rows of
    every width, an isolated state (S - 2), integer weights in [-1, 1]."""
    rng = np.random.RandomState(seed)
    dst = np.concatenate([np.full(150, 0), np.full(40, 1), np.full(17, 2), np.full(9, 3)]
                         + [np.full(rng.randint(1, 8), s) for s in range(4, S - 2)]
                         + [np.full(3, S - 1)])
    src = rng.randint(0, S, dst.size)
    src[src == S - 2] = 0
    label = rng.randint(0, 4, dst.size)
    w = rng.randint(-1, 2, dst.size)
    start = np.full(S, NEG)
    start[:3] = (0, 1, 0)
    accept = np.zeros(S)
    port, _ = _tables(src, dst, label, w, start, accept)
    return vsp.build_plan(port)


@pytest.mark.parametrize("cap", [None, 1, 2])
def test_lane_schedule_emulation_matches_scan_plain(cap):
    """The kernel on its schedule, emulated in float32, is bitwise
    ``viterbi_scan_fwd_plain`` on integer inputs with exact ties across the
    lanes of a group and (caps 1 and 2: state 0 in 5 and 3 chunks, at cap 1
    state 1 in 2) across a hub's warps; ragged lengths and a sample of
    length 0."""
    plan = _tie_table()
    packed = vsp.pack_buckets(plan.src_bucket, plan.label_bucket, plan.w_bucket, cap)
    rng = np.random.RandomState(41)
    B, T, S = 3, 6, plan.S
    em = rng.randint(-1, 2, (B, T, 4)).astype(np.float32)
    lens = np.asarray([T, T - 2, 0], np.int32)
    slots, final, _, lane_ties, hub_ties = _emulate_scan(packed, em, lens, plan.start.numpy(),
                                                        S)
    slots_p, final_p = vsp.viterbi_scan_fwd_plain(
        torch.from_numpy(em), plan.src_bucket, plan.label_bucket, plan.w_bucket, plan.start,
        torch.from_numpy(lens))
    np.testing.assert_array_equal(slots, slots_p.numpy())
    np.testing.assert_array_equal(final, final_p.numpy())
    assert lane_ties > 0 and (slots < vsp.DEAD).any()
    assert (packed.hubs, packed.chunks) == {None: (0, 0), 1: (2, 7), 2: (1, 3)}[cap]
    if cap is not None:
        assert hub_ties > 0


def test_routes():
    """The scan's route by plan: the headline's arcs in registers (one
    slot a warp), a table of 25,760 arcs in shared memory, one past shared
    memory in global memory, each with its emission rows all staged where
    they fit, else in a ring; a state past shared memory raises, and so
    does a forced route that does not fit."""
    import chip_smoke

    routes = {}
    for n in (chip_smoke.N, 2 * chip_smoke.N, 3 * chip_smoke.N):
        _, src_b, lab_b, w_b, *_ = chip_smoke.viterbi_headline_inputs(torch, "cpu", b=1,
                                                                        t=2, n=n)
        packed = vsp.pack_buckets(src_b, lab_b, w_b)
        route = vsp.scan_route(packed, src_b.shape[1], n)
        routes[n] = (route, packed.cap, packed.slots)
        assert vsp.route_fits(packed, src_b.shape[1], n, "global")
        # a sample's 250 emission rows staged at 80 channels (80 KB); a
        # ring of them beside 206 KB of staged arcs, or at 240 channels
        assert vsp.scan_rows(packed, src_b.shape[1], 250, n, route) == (
            250 if n == chip_smoke.N else vsp.RING)
        assert vsp.scan_rows(packed, src_b.shape[1], 10**5, n, route) == vsp.RING
    assert routes == {80: ("registers", 12, 20), 160: ("shared", 12, 80),
                      240: ("global", 12, 240)}
    assert not vsp.route_fits(packed, 242, 240, "registers")
    with pytest.raises(ValueError, match="does not fit"):
        vsp.scan_route(packed, 242, 10**5)
    with pytest.raises(ValueError, match="route"):
        vsp.route_fits(packed, 242, 240, "texture")


@pytest.mark.parametrize("cap", [None, 2])
def test_walk_emulation_matches_backtrace_plain(cap):
    """The decode's walk on the kernel's walk words, emulated (the words
    from the lanes' winning arcs, the block's argmax with ties across
    threads and warps, one word a frame), is bitwise
    ``viterbi_backtrace_plain`` on the plain scan's slots: integer inputs
    with exact ties (at cap 2 across a hub's chunks), ragged lengths, a
    sample of length 0 and one with an all-NEG frame (infeasible)."""
    plan = _tie_table()
    packed = vsp.pack_buckets(plan.src_bucket, plan.label_bucket, plan.w_bucket, cap)
    rng = np.random.RandomState(42)
    B, T, S = 4, 7, plan.S
    em = rng.randint(-1, 2, (B, T, 4)).astype(np.float32)
    em[3, 2] = NEG
    lens = np.asarray([T, T - 3, 0, T], np.int32)
    accept = plan.accept.numpy()
    slots, final, walk, _, _ = _emulate_scan(packed, em, lens, plan.start.numpy(), S)
    threads = vsp.WARP * max(1, min(packed.slots, vsp.MAX_WARPS))
    labels, score, ties, _ = _emulate_walk(walk, final, accept, lens, threads)
    slots_p, final_p = vsp.viterbi_scan_fwd_plain(
        torch.from_numpy(em), plan.src_bucket, plan.label_bucket, plan.w_bucket, plan.start,
        torch.from_numpy(lens))
    np.testing.assert_array_equal(slots, slots_p.numpy())
    labels_p, score_p = vsp.viterbi_backtrace_plain(slots_p, final_p, plan.accept,
                                                    plan.src_bucket, plan.label_bucket)
    np.testing.assert_array_equal(labels, labels_p.numpy())
    np.testing.assert_array_equal(score, score_p.numpy())
    assert ties > 0 and (labels[:2] >= 0).any()
    assert (labels[2] == -1).all() and (labels[3] == -1).all() and score[3] <= NEG / 2


def test_walk_takes_dead_words_as_the_plain_backtrace_takes_dead_slots():
    """A DEAD slot on the walked path (reachable only with weights past
    NEG's reach; here written into the slots) gives label -1 and keeps the
    state, in the emulated walk over its word (state | DEAD_LABEL << 16)
    as in ``viterbi_backtrace_plain``."""
    plan = _tie_table()
    rng = np.random.RandomState(43)
    B, T, S = 2, 6, plan.S
    em = torch.from_numpy(rng.randint(-1, 2, (B, T, 4)).astype(np.float32))
    lens = torch.tensor([T, T - 1], dtype=torch.int32)
    slots, final = vsp.viterbi_scan_fwd_plain(em, plan.src_bucket, plan.label_bucket,
                                              plan.w_bucket, plan.start, lens)
    labels, _ = vsp.viterbi_backtrace_plain(slots, final, plan.accept, plan.src_bucket,
                                            plan.label_bucket)
    # the walked states, then a DEAD slot at frame 3 of each sample's path
    state = torch.max(final + plan.accept, dim=1).indices
    for t in reversed(range(T)):
        if t == 3:
            slots[torch.arange(B), t, state] = vsp.DEAD
            break
        d = slots[torch.arange(B), t, state]
        keep = d < vsp.DEAD
        state = torch.where(keep, plan.src_bucket.long()[d.clamp(max=plan.D - 1).long(), state],
                            state)
    src, lab = plan.src_bucket.long(), plan.label_bucket.long()
    d = slots.long().clamp(max=plan.D - 1)
    states = torch.arange(S)[None, None, :].expand_as(d)
    walk = torch.where(slots < vsp.DEAD, src[d, states] | lab[d, states] << 16,
                       states | vsp.DEAD_LABEL << 16).numpy()
    threads = vsp.WARP
    got, _, _, dead = _emulate_walk(walk, final.numpy(), plan.accept.numpy(), lens.numpy(),
                                    threads)
    want, _ = vsp.viterbi_backtrace_plain(slots, final, plan.accept, plan.src_bucket,
                                          plan.label_bucket)
    np.testing.assert_array_equal(got, want.numpy())
    assert dead >= B and (want[:, 3] == -1).all() and not torch.equal(want, labels)


def test_walk_routes():
    """The decode's walk route beside the scan's: the headline (S=82,
    T=250, C=80) keeps its words in shared memory with every emission row
    staged; the backoff trigram path's decode table (S=95, 1,932 arcs,
    C=12) at T=300 too; at T=608, its longest lines, the words go to the
    global scratch and are walked by chunks (walk "chunked"); at 10^5
    frames nothing fits and the route raises; the walk's shared memory is
    what the kernel's layout takes."""
    import chip_smoke
    from gtn_applications_tpu_torch import datasets, utils

    _, src_b, lab_b, w_b, *_ = chip_smoke.viterbi_headline_inputs(torch, "cpu", b=1, t=2)
    head = vsp.pack_buckets(src_b, lab_b, w_b)
    config = chip_smoke.main_path_config("transducer_backoff")
    data = getattr(datasets, config["data"]["dataset"])
    pre = data.Preprocessor(None, num_features=config["data"]["num_features"])
    crit, _ = utils.load_criterion(config["criterion_type"], pre, config["criterion"])
    plan = vsp.build_plan(crit._decode_table(crit.params))
    trigram = plan.packed("cpu")
    assert (plan.S, trigram.A, crit.num_channels) == (95, 1932, 12)
    got = {}
    for name, packed, S, C, T in (("headline", head, 82, 80, 250),
                                  ("trigram", trigram, 95, 12, 300),
                                  ("trigram_T608", trigram, 95, 12, 608)):
        route = vsp.scan_route(packed, S, C, "chunked", T)
        walk = vsp.walk_route(packed, S, T, C, route)
        got[name] = (route, walk, vsp.scan_rows(packed, S, T, C, route, walk))
        assert vsp.walk_words(S, T, "shared") == -(-T * S // 4) * 4 + -(-T // 4) * 4 + 64
    assert got == {"headline": ("registers", "shared", 250),
                   "trigram": ("registers", "shared", 300),
                   "trigram_T608": ("registers", "chunked", 608)}
    assert vsp.walk_words(95, 608, "chunked") == 2 * vsp.WALK_CHUNK * 96 + 608 + 64
    assert vsp.walk_words(95, 608, None) == 0
    with pytest.raises(ValueError, match="fit"):
        vsp.scan_route(trigram, 95, 12, "chunked", 10**5)
    with pytest.raises(ValueError, match="walk"):
        vsp.route_fits(trigram, 95, 12, "registers", "texture", 10)


def test_profile_copies_match_the_kernel_source():
    """Each copy ``scripts/profile_viterbi.py`` builds of ``csrc/viterbi.cu``
    (a part of the scan's frame removed, or ``clock64`` marks added) still
    finds every piece of source it changes exactly once."""
    from gtn_applications_tpu_torch.scripts import profile_viterbi as prof

    src = prof.SOURCE.read_text()
    for name, subs in dict(prof.VARIANTS, clocks=prof.CLOCKS).items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)
