"""The port's whole tropical scan ``seg_max_scan`` and its backtrace.

``seg_max_scan_plain`` (what CPU tensors take) against a ``jax.lax.scan``
of JAX ``segmax_pallas.seg_max`` (its Pallas kernel in interpret mode
off-TPU) with the length mask of JAX's ``_viterbi_batched_pallas``, on
both step-decode tables of ``tests/test_torch_viterbi_scan.py`` (JAX's own
test graph and an unpruned grapheme 4-gram's decode table, which the
bucket plan refuses), at T = 9 and T = 1 with ragged lengths and an
all-NEG frame: backarcs and final alpha bitwise.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
these plain versions.  Here its schedule is held by a float32 emulation of
what the kernel does on it (lane groups, hub chunks, ranks of a cluster of
k = 1, 2, 4, 8 blocks, the merge of (value, position) pairs, the frame
loop and the walk back) on a table whose hub spans three chunks, with
integer inputs that tie across chunks and lanes: bitwise against
``seg_max_scan_plain`` and ``seg_max_backtrace_plain``.  With the CUDA
route forced and a plain stand-in for the launch, the decode goes through
one ``seg_max_scan_cuda`` call and nothing per frame, a failed launch
raises, and the Transducer builds its decode table's ``ScanPlan`` once
across re-weighted decodes.  Last, ``chip_smoke.py``'s check of the kernel
runs with the plain versions standing in and must fail on one backarc or
one label changed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import segmax_pallas as jax_smp
from gtn_applications_tpu.ops import semiring as jax_semiring
from gtn_applications_tpu_torch.criterions import transducer as td
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.ops import _build, sparse
from gtn_applications_tpu_torch.ops import segmax_pallas as smp
from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
from gtn_applications_tpu_torch.ops.seglse_pallas import untake
from gtn_applications_tpu_torch.ops.semiring import NEG
from gtn_applications_tpu_torch.ops.sparse import ArcTable
from gtn_applications_tpu_torch.scripts.build_transitions import grapheme_lm

from tests.test_torch_sparse_scan import _butterfly, _lanes, _part
from tests.test_torch_viterbi_scan import _step_tables

INT_MAX = 2**31 - 1


def _jax_scan(em, jtable, lens):
    """(backarcs [B, T, S], final alpha [B, S]): JAX's ``seg_max`` scanned
    over the frames as ``_viterbi_batched_pallas`` scans it."""
    as2d = lambda x: x[None] if x.ndim == 1 else x  # noqa: E731
    src, dst, w, label = (as2d(getattr(jtable, f)) for f in ("src", "dst", "weight", "label"))
    B, T, _ = em.shape
    em_arc = jax_semiring.gather_channels(
        em, jnp.broadcast_to(label, (B, label.shape[-1]))).transpose(1, 0, 2)

    def step(alpha, xs):
        em_t, t = xs
        new, arc = jax_smp.seg_max(alpha, src, dst, w, em_t)
        live = (t < lens)[:, None]
        return jnp.where(live, new, alpha), jnp.where(live, arc, jnp.int32(2**30))

    alpha0 = jnp.broadcast_to(as2d(jtable.start), (B, jtable.start.shape[-1]))
    alpha, backarcs = jax.lax.scan(step, alpha0, (em_arc, jnp.arange(T)))
    return np.asarray(backarcs).transpose(1, 0, 2), np.asarray(alpha)


@pytest.mark.parametrize("T", [9, 1])
@pytest.mark.parametrize("name", ["seglse test graph", "4-gram"])
def test_scan_plain_matches_jax_kernel(name, T):
    table, jtable, C = _step_tables(name)
    rng = np.random.default_rng(20 + T)
    em = rng.normal(size=(3, T, C)).astype(np.float32)
    em[2, T // 2] = NEG  # an all-NEG frame: sample 2 has no accepting path
    lens = np.asarray([T, max(T - 4, 0), T], np.int32)
    back, final = smp.seg_max_scan_plain(torch.from_numpy(em), table, torch.from_numpy(lens))
    j_back, j_final = _jax_scan(jnp.asarray(em), jtable, jnp.asarray(lens))
    assert back.dtype == torch.int32 and back.shape == (3, T, table.start.shape[0])
    np.testing.assert_array_equal(back.numpy(), j_back)
    np.testing.assert_array_equal(final.numpy(), j_final)
    assert (back[1, max(T - 4, 0):] == smp.BIG).all()  # past the length
    labels, score = smp.seg_max_backtrace_plain(back, final, table)
    assert labels[2].tolist() == [-1] * T and float(score[2]) <= NEG / 2


# ---------------------------------------------------------------------------
# The kernel's schedule, emulated
# ---------------------------------------------------------------------------

EMU_S, EMU_C, EMU_B, EMU_T = 48, 5, 3, 4
# in-degrees of the first states: a hub of three 256-arc chunks, and rows
# for each lane group (32, 8, 4 and 1 lanes)
EMU_DEGREES = (700, 150, 50, 20, 5)


def _emu_table(seed):
    """A decode table (1-D fields) with the in-degrees above, random
    in-degrees of 0-8 elsewhere, arcs whose source is -1, padding arcs
    (state 0 to the last state, weight NEG, as ``to_arc_table`` pads) and
    labels outside [0, C); integer weights, start and accept; arcs in a
    random order, so sorted positions are not arc ids."""
    rng = np.random.RandomState(seed)
    dst = np.concatenate([np.full(n, s) for s, n in enumerate(EMU_DEGREES)]
                         + [np.full(rng.randint(0, 9), s)
                            for s in range(len(EMU_DEGREES), EMU_S)])
    src = rng.randint(0, EMU_S, dst.size)
    src[rng.rand(dst.size) < 0.03] = -1
    w = rng.randint(-1, 2, dst.size).astype(np.float32)
    label = rng.randint(-1, EMU_C + 1, dst.size)
    pad = 10
    src, dst = np.r_[src, np.zeros(pad)], np.r_[dst, np.full(pad, EMU_S - 1)]
    w, label = np.r_[w, np.full(pad, NEG)], np.r_[label, np.zeros(pad)]
    perm = rng.permutation(src.size)
    start = rng.randint(-2, 3, EMU_S).astype(np.float32)
    start[rng.rand(EMU_S) < 0.2] = NEG
    accept = rng.randint(-2, 3, EMU_S).astype(np.float32)
    accept[rng.rand(EMU_S) < 0.5] = NEG
    i32 = lambda x: torch.from_numpy(np.asarray(x)[perm].astype(np.int32))  # noqa: E731
    z = torch.zeros(0, dtype=torch.int32)
    return ArcTable(i32(src), i32(dst), i32(label), torch.from_numpy(w[perm].astype(np.float32)),
                    torch.from_numpy(start), torch.from_numpy(accept), z, z, torch.zeros(0))


def _merge(x, y, ties):
    """The kernels' merge of (value, position): greater value, else lower
    position; counts the exact ties above NEG it decides."""
    if x[0] == y[0] and x[0] > NEG:
        ties[0] += 1
    return x if (x[0] > y[0] or (x[0] == y[0] and x[1] < y[1])) else y


def _emulate_max(lst, value, ties):
    """One tropical phase of a rank as the kernel runs it: per lane a
    strict > over its increasing positions, the lanes of a group merged by
    xor shuffles, a hub's chunks merged in shared memory.  {row: (max,
    position)}; ties: [across lanes, across hub chunks]."""
    slots, hubs = lst
    out, part = {}, {}
    lane_ties = [0]
    for g, tasks in slots:
        for key, beg, end, aux in tasks:
            lanes = []
            for arcs in _lanes(g, beg, end):
                best = (-np.inf, INT_MAX)
                for kk in arcs:
                    c = value(kk)
                    if c > best[0]:
                        best = (c, kk)
                lanes.append(best)
            m = _butterfly(lanes, lambda x, y: _merge(x, y, lane_ties))
            if aux >= 0:
                part[aux & 0xFFFF] = m
            else:
                out[key] = m
    chunk_ties = [0]
    for key, pb, n in hubs:
        m = (-np.inf, INT_MAX)
        for p in range(pb, pb + n):
            m = _merge(m, part[p], chunk_ties)
        out[key] = m
    ties[0] += lane_ties[0]
    ties[1] += chunk_ties[0]
    return out


def _emulate_scan(table, em, lens, k):
    """``seg_max_scan_kernel`` on ``build_schedule``'s schedule for clusters
    of k blocks, reading the arcs as the kernel gets them
    (``decode_arcs``), in float32: (backarcs, final, labels, score, ties)."""
    C = em.shape[2]
    with pytest.MonkeyPatch.context() as m:  # the plan's CUDA index, on the CPU
        m.setattr(_build, "on_cuda", lambda x: True)
        plan = smp.decode_plan(table, C, "cpu")
    idx = plan.main
    sched = ssp.build_schedule(idx, None, EMU_S, C, k)
    parts = [_part(sched.words[0, q]) for q in range(k)]
    packed, order, dropped = (x[0].numpy() for x in smp.decode_arcs(plan))
    srt_src, srt_lab = packed & 0xFFFF, packed >> 16
    w_s = np.where(dropped, -np.inf, table.weight.numpy()[idx.order[0].numpy()])
    w_s = w_s.astype(np.float32)
    emz = np.concatenate([em.numpy(), np.zeros(em.shape[:2] + (1,), np.float32)], 2)
    lens = lens.numpy()
    B, T = em.shape[:2]
    f32 = np.float32
    backarcs = np.full((B, T, EMU_S), smp.BIG, np.int32)
    final = np.empty((B, EMU_S), np.float32)
    ties = [0, 0]
    for b in range(B):
        alpha = table.start.numpy().copy()
        for t in range(min(max(int(lens[b]), 0), T)):
            def value(kk):  # the kernel's sum: no branch
                return f32(f32(alpha[srt_src[kk]] + w_s[kk]) + emz[b, t, srt_lab[kk]])  # noqa: B023

            new = np.full(EMU_S, np.nan, np.float32)
            for ranges, lists in parts:
                for key, (m, kk) in _emulate_max(lists[0], value, ties).items():
                    assert ranges["s0"] <= key < ranges["s1"] and np.isnan(new[key])
                    new[key] = m if m > NEG else NEG
                    backarcs[b, t, key] = order[kk] if m > NEG else smp.BIG
            assert not np.isnan(new).any()  # every state emitted, once
            alpha = new
        final[b] = alpha
    # the walk: the first argmax of final + accept, then back through the
    # live frames (backarcs past the length are not read)
    A = table.src.shape[0]
    tsrc, tlab = table.src.numpy(), table.label.numpy()
    scored = final + table.accept.numpy()
    labels = np.full((B, T), -1, np.int32)
    score = np.empty(B, np.float32)
    for b in range(B):
        best = (-np.inf, INT_MAX)
        for s in range(EMU_S):
            best = _merge(best, (scored[b, s], s), [0])
        score[b], state = best
        if best[0] <= f32(NEG / 2):
            continue
        for t in reversed(range(min(max(int(lens[b]), 0), T))):
            arc = backarcs[b, t, state]
            if arc < A:
                labels[b, t], state = tlab[arc], tsrc[arc]
    return backarcs, final, labels, score, ties


@pytest.mark.parametrize("k", ssp.CLUSTER_SIZES)
def test_schedule_emulation_matches_scan_plain(k):
    table = _emu_table(50)
    rng = np.random.RandomState(51 + k)
    em = torch.from_numpy(rng.randint(-1, 2, (EMU_B, EMU_T, EMU_C)).astype(np.float32))
    lens = torch.tensor([EMU_T, EMU_T - 2, 0], dtype=torch.int32)
    back, final, labels, score, ties = _emulate_scan(table, em, lens, k)
    back_p, final_p = smp.seg_max_scan_plain(em, table, lens)
    labels_p, score_p = smp.seg_max_backtrace_plain(back_p, final_p, table)
    np.testing.assert_array_equal(back, back_p.numpy())
    np.testing.assert_array_equal(final, final_p.numpy())
    np.testing.assert_array_equal(labels, labels_p.numpy())
    np.testing.assert_array_equal(score, score_p.numpy())
    assert ties[0] > 0 and ties[1] > 0  # ties across lanes and across hub chunks
    assert (labels >= 0).any() and (back < smp.BIG).any()
    idx = smp.arc_index(table.src[None], table.dst[None], EMU_S, table.label[None], EMU_C)
    hubs = [h for _, lists in (_part(w) for w in ssp.build_schedule(
        idx, None, EMU_S, EMU_C, k).words[0]) for h in lists[0][1]]
    assert [(key, n) for key, _, n in hubs] == [(0, 3)]  # the hub: three chunks


# ---------------------------------------------------------------------------
# The CUDA route, with plain stand-ins for the launch
# ---------------------------------------------------------------------------


def _kernel_stand_in(monkeypatch, calls, originals):
    """``seg_max_scan_cuda``'s function from its own inputs (the table's
    structure from the plan, the weights back from the sorted order),
    computed by the plain versions captured before any patching."""
    scan_plain, backtrace_plain, step_plain = originals

    def run(em, w_s, start, accept, lens, plan, cluster=None):
        calls.append(plan)
        z = plan.src[0, :0]
        tab = ArcTable(plan.src[0], plan.dst[0], plan.label[0],
                       untake(w_s, plan.main.order)[0], start, accept, z, z,
                       torch.zeros(0))
        with monkeypatch.context() as m:
            m.setattr(smp, "seg_max_plain", step_plain)
            back, final = scan_plain(em, tab, lens)
            return (back, final) + backtrace_plain(back, final, tab)
    return run


def _force_cuda_route(monkeypatch):
    """The CUDA route on CPU tensors: a stand-in for the launch, and every
    per-frame step and plain version raising where ``ops/sparse.py`` would
    reach them.  Returns the stand-in's calls."""
    calls = []
    originals = (smp.seg_max_scan_plain, smp.seg_max_backtrace_plain, smp.seg_max_plain)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route reached a per-frame step or a plain version")

    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(smp, "seg_max_scan_cuda", _kernel_stand_in(monkeypatch, calls,
                                                                   originals))
    for name in ("seg_max_cuda", "seg_max_plain", "seg_max_scan_plain",
                 "seg_max_backtrace_plain"):
        monkeypatch.setattr(smp, name, refuse)
    return calls


def test_cuda_route_is_one_launch_and_nothing_per_frame(monkeypatch):
    """On a CUDA tensor ``_viterbi_batched`` makes one ``seg_max_scan_cuda``
    call (the scan and its backtrace are one launch) and reaches neither
    ``seg_max`` nor a plain version; a launch that fails raises, with no
    fallback."""
    table, _, C = _step_tables("4-gram")
    rng = np.random.default_rng(30)
    T = 7
    em = torch.from_numpy(rng.normal(size=(4, T, C)).astype(np.float32))
    lens = torch.tensor([T, T - 3, 2, T], dtype=torch.int32)
    want = sparse._viterbi_batched(em, table, lens)
    calls = _force_cuda_route(monkeypatch)
    labels, score = sparse._viterbi_batched(em, table, lens)
    assert len(calls) == 1
    assert torch.equal(labels, want[0]) and torch.equal(score, want[1])
    labels, _ = sparse.viterbi_batch(em, table, lens)
    assert len(calls) == 2 and torch.equal(labels, want[0])

    def fail(*args, **kwargs):
        raise RuntimeError("seg_max_scan: CUDA error at launch")

    monkeypatch.setattr(smp, "seg_max_scan_cuda", fail)
    with pytest.raises(RuntimeError, match="seg_max_scan"):
        sparse._viterbi_batched(em, table, lens)


def test_transducer_builds_its_decode_plan_once(monkeypatch):
    """Re-weighted decodes (a new parameter tensor, then an in-place
    update) reuse one ``ScanPlan``: the table's index and schedules are
    built once per criterion; each decode equals the CPU route's."""
    pre = synthetic.Preprocessor(None, num_features=16)
    texts = synthetic.Dataset(None, pre, split="train").texts[:16]
    crit = td.Transducer(pre.tokens, pre.graphemes_to_index, blank="optional",
                         allow_repeats=False,
                         transitions=grapheme_lm(texts, pre.tokens, (0, 0, 0, 0)))
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randn(3, 6, crit.num_channels).astype(np.float32))
    lens = torch.tensor([6, 4, 5], dtype=torch.int32)
    w1 = torch.from_numpy((rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32))
    want = [crit.viterbi(x, {"transitions": w}, lens) for w in (w1, w2, w1 + 0.25)]
    built = []
    scan_plan = ssp.scan_plan
    monkeypatch.setattr(ssp, "scan_plan", lambda *a: built.append(1) or scan_plan(*a))
    calls = _force_cuda_route(monkeypatch)
    got = [crit.viterbi(x, {"transitions": w}, lens) for w in (w1, w2)]
    w1.add_(0.25)  # the optimizer's in-place update
    got.append(crit.viterbi(x, {"transitions": w1}, lens))
    assert len(built) == 1 and len(calls) == 3
    assert all(plan is calls[0] for plan in calls)
    for g, w in zip(got, want):
        assert [p.tolist() for p in g] == [p.tolist() for p in w]


# ---------------------------------------------------------------------------
# chip_smoke.py's check of the kernel, with the plain versions standing in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("broken", [None, "backarc", "label"])
def test_smoke_segmax_scan_check_holds_outputs_bitwise(monkeypatch, broken):
    """``chip_smoke.hold_segmax_scan`` with a plain stand-in for the launch:
    it passes at every cluster size as it is, and fails with one backarc
    moved or one backtrace label changed."""
    import chip_smoke

    calls = []
    stand_in = _kernel_stand_in(
        monkeypatch, calls,
        (smp.seg_max_scan_plain, smp.seg_max_backtrace_plain, smp.seg_max_plain))

    def run(*args, cluster=None):
        assert cluster in ssp.CLUSTER_SIZES
        back, final, labels, score = stand_in(*args)
        if broken == "backarc":
            live = (back < smp.BIG).nonzero()
            back[tuple(live[len(live) // 2])] += 1
        elif broken == "label":
            live = (labels >= 0).nonzero()
            labels[tuple(live[len(live) // 2])] += 1
        return back, final, labels, score

    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(smp, "seg_max_scan_cuda", run)
    monkeypatch.setattr(smp, "max_active_clusters", lambda plan, k, dev: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    em, lens, table = chip_smoke.segmax_scan_inputs(torch, "cpu", b=3, t=6, seed=14)
    assert tuple(table.src.shape) == (35455,)  # the 4-gram decode table
    check = lambda: chip_smoke.hold_segmax_scan(  # noqa: E731
        torch, em, lens, table, "cpu", clusters=ssp.CLUSTER_SIZES)
    if broken:
        with pytest.raises(AssertionError, match="backarcs" if broken == "backarc"
                           else "labels"):
            check()
    else:
        assert check() == {"seg_max_scan": 0.0}
        assert len(calls) == len(ssp.CLUSTER_SIZES)
        assert len({id(p) for p in calls}) == 1  # one plan for every size


def test_smoke_counts_one_decode_launch_a_batch():
    """The 4-gram path's expected launches: one ``seg_max_scan`` a decoded
    batch, ``seg_max`` never; the trigram's decode the whole-scan Viterbi."""
    import chip_smoke

    for path, whole in (("transducer_backoff", True), ("transducer_backoff_4gram", False)):
        expected = chip_smoke.backoff_expected_launches(
            chip_smoke.main_path_config(path), steps=4, evals=3)
        assert expected["seg_max"] == 0
        assert expected["seg_max_scan"] == (0 if whole else 7)
        assert expected["viterbi_scan_fwd"] == expected["viterbi_backtrace"] == (
            7 if whole else 0)
    assert "seg_max_scan" in chip_smoke.PATHS["transducer_backoff_4gram"][1]
    assert [name for name, *_ in chip_smoke.KERNELS][-2:] == ["seg_max", "seg_max_scan"]
    assert len(chip_smoke.KERNELS) == 17


def test_decode_smem_plan_refuses_a_state_past_shared_memory():
    """The state (alpha and the rows by frame parity) must fit in shared
    memory; the tables may lie in global memory."""
    sizes = dict(states=100, arcs=10**6, parts=4, dst_words=500)
    assert not smp.decode_route(sizes, 1058, 12)
    assert smp.decode_smem_bytes(sizes, 1058, 12) == 4 * smp.decode_smem_words(
        sizes, 1058, 12)[0]
    assert smp.decode_route(dict(sizes, arcs=1000), 1058, 12)
    with pytest.raises(ValueError, match="does not fit"):
        smp.decode_route(sizes, 40000, 12)

