"""The port's ASG criterion against the JAX package and the ASG goldens.

The loss and its gradients with respect to the emissions and the
transitions go through ``lattice.asg_loss`` of both packages on the same
numpy-seeded inputs (loss atol 1e-5, gradients atol 1e-6: fp32 scans over
up to 20 frames, exp/log and matrix products taken by two libraries).  The
golden 7.47995 and the gradient tables of ``tests/test_asg.py`` hold to
their own tolerances there (loss 1e-4, gradients rtol 2e-3 + atol 1e-4).
The Viterbi decode gives the same paths exactly and scores within 1e-6,
ties included; ``dense_backtrace_plain`` gives exactly the paths of JAX
``dense_backtrace`` (its Pallas kernel in interpret mode), T = 1 included.
The backtrace kernel's ring of chunks (``viterbi_scan_pallas.dense_bt_plan``)
is emulated with numpy, its copies split as the kernel splits them, and
held bitwise to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions import asg as jax_asg
from gtn_applications_tpu.criterions.common import pad_targets as jax_pad_targets
from gtn_applications_tpu.ops import lattice as jax_lattice
from gtn_applications_tpu.ops import viterbi_scan_pallas as jax_vsp
from gtn_applications_tpu_torch.criterions import ASG
from gtn_applications_tpu_torch.criterions import asg as asg_mod
from gtn_applications_tpu_torch.criterions.common import pad_targets
from gtn_applications_tpu_torch.models.convert import criterion_params_from_jax
from gtn_applications_tpu_torch.ops import _build, lattice
from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

from .test_asg import EMISSIONS, LABELS


def _port_loss_and_grads(em, trans, targets_list, reduction, lens=None):
    x = torch.from_numpy(em).requires_grad_(True)
    tr = torch.from_numpy(trans).requires_grad_(True)
    targets, lengths = pad_targets(targets_list)
    il = None if lens is None else torch.from_numpy(lens)
    loss = lattice.asg_loss(x, tr, targets, lengths, reduction, il)
    loss.backward()
    return float(loss.detach()), x.grad.numpy(), tr.grad.numpy()


# the gradient tables of tests/test_asg.py, before their division by B
GOLDEN_EM_GRAD = np.asarray([
    0.1060, 0.1595, -0.7639, 0.2485, 0.1118, 0.1380,
    0.1915, -0.7524, 0.1539, 0.1175, 0.1717, 0.1178,
    0.1738, 0.1137, 0.2288, 0.1216, 0.1678, -0.8057,
    0.1766, -0.7923, 0.1902, 0.0988, 0.2056, 0.1210,
    0.1212, 0.1422, 0.2059, -0.8160, 0.2166, 0.1300,
    0.2029, 0.1164, 0.1325, 0.2383, -0.8032, 0.1131,
    0.1414, 0.2602, 0.1263, -0.3441, -0.3009, 0.1172,
    0.1557, 0.1788, 0.1496, -0.5498, 0.0140, 0.0516,
    0.2306, 0.1219, 0.1503, -0.4244, 0.1796, -0.2579,
    0.2149, 0.1745, 0.1160, 0.1271, 0.1350, -0.7675,
    0.2195, 0.1458, 0.1770, -0.8395, 0.1307, 0.1666,
    0.2148, 0.1237, -0.6613, -0.1223, 0.2191, 0.2259,
    0.2002, 0.1077, -0.8386, 0.2310, 0.1440, 0.1557,
    0.2197, -0.1466, -0.5742, 0.1510, 0.2160, 0.1342,
    0.1050, -0.8265, 0.1714, 0.1917, 0.1488, 0.2094,
], np.float32).reshape(3, 5, 6)
GOLDEN_TRANS_GRAD = np.asarray([
    0.3990, 0.3396, 0.3486, 0.3922, 0.3504, 0.3155,
    0.3666, 0.0116, -1.6678, 0.3737, 0.3361, -0.7152,
    0.3468, 0.3163, -1.1583, -0.6803, 0.3216, 0.2722,
    0.3694, -0.6688, 0.3047, -0.8531, -0.6571, 0.2870,
    0.3866, 0.3321, 0.3447, 0.3664, -0.2163, 0.3039,
    0.3640, -0.6943, 0.2988, -0.6722, 0.3215, -0.1860,
], np.float32).reshape(6, 6)


def test_asg_golden_fwd_bwd():
    N, B = 6, 3
    loss, g_em, g_tr = _port_loss_and_grads(
        EMISSIONS, np.zeros((N + 1, N), np.float32), LABELS, "none")
    assert abs(loss - 7.47995) < 1e-4
    np.testing.assert_allclose(g_em, GOLDEN_EM_GRAD / B, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(g_tr[1:], GOLDEN_TRANS_GRAD / B, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("seed,B,T,N,reduction,ragged", [
    (0, 3, 9, 6, "mean", False), (1, 4, 14, 8, "none", True),
    (2, 2, 20, 5, "mean", True),
])
def test_asg_loss_matches_jax(seed, B, T, N, reduction, ragged):
    import jax

    rng = np.random.RandomState(seed)
    em = rng.randn(B, T, N).astype(np.float32)
    trans = (rng.randn(N + 1, N) * 0.3).astype(np.float32)
    targets_list = [rng.randint(0, N, size=rng.randint(1, 5)).tolist()
                    for _ in range(B)]
    lens = rng.randint(T // 2, T + 1, size=B).astype(np.int32) if ragged else None

    loss, g_em, g_tr = _port_loss_and_grads(em, trans, targets_list, reduction, lens)
    targets, lengths = jax_pad_targets(targets_list)
    j_lens = None if lens is None else jnp.asarray(lens)
    j_loss, (j_em, j_tr) = jax.value_and_grad(
        lambda e, t: jax_lattice.asg_loss(e, t, targets, lengths, reduction, j_lens),
        argnums=(0, 1),
    )(jnp.asarray(em), jnp.asarray(trans))
    assert abs(loss - float(j_loss)) < 1e-5
    np.testing.assert_allclose(g_em, np.asarray(j_em), atol=1e-6)
    np.testing.assert_allclose(g_tr, np.asarray(j_tr), atol=1e-6)


def test_replabel_pack_unpack_match_jax():
    assert asg_mod.pack_replabels([0, 1, 1, 2], 1) == [1, 2, 0, 3]
    assert asg_mod.unpack_replabels([1, 2, 0, 3], 1) == [0, 1, 1, 2]
    tokens = [0, 0, 0, 1, 2, 2, 3, 3, 3, 3]
    for k in range(0, 4):
        packed = asg_mod.pack_replabels(tokens, k)
        assert packed == jax_asg.pack_replabels(tokens, k)
        assert asg_mod.unpack_replabels(packed, k) == tokens
    assert asg_mod.unpack_replabels([0, 0, 3], 1) == jax_asg.unpack_replabels([0, 0, 3], 1)


@pytest.mark.parametrize("seed,B,T,C,ties", [
    (0, 4, 9, 5, False), (1, 3, 12, 7, True), (2, 2, 1, 4, False),
])
def test_asg_viterbi_matches_jax(seed, B, T, C, ties):
    rng = np.random.RandomState(seed)
    if ties:  # small integers: many equal scores, ties go to the lowest index
        out = rng.randint(0, 2, size=(B, T, C)).astype(np.float32)
        trans = rng.randint(0, 2, size=(C + 1, C)).astype(np.float32)
    else:
        out = rng.randn(B, T, C).astype(np.float32)
        trans = rng.randn(C + 1, C).astype(np.float32)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    for il in (None, lens):
        path, score = lattice.asg_viterbi(
            torch.from_numpy(out), torch.from_numpy(trans),
            None if il is None else torch.from_numpy(il))
        j_path, j_score = jax_lattice.asg_viterbi(
            jnp.asarray(out), jnp.asarray(trans),
            None if il is None else jnp.asarray(il))
        np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
        np.testing.assert_allclose(score.numpy(), np.asarray(j_score), atol=1e-6)


@pytest.mark.parametrize("B,T,C", [(3, 1, 5), (4, 2, 6), (5, 17, 9)])
def test_dense_backtrace_plain_matches_jax(B, T, C):
    rng = np.random.RandomState(B * T + C)
    bp = rng.randint(0, C, size=(B, T - 1, C)).astype(np.int32)
    last = rng.randint(0, C, size=B).astype(np.int32)
    path = vsp.dense_backtrace(torch.from_numpy(bp), torch.from_numpy(last))
    j_path = jax_vsp.dense_backtrace(
        jnp.asarray(bp.transpose(1, 0, 2)), jnp.asarray(last), C)
    assert path.dtype == torch.int32 and tuple(path.shape) == (B, T)
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
    np.testing.assert_array_equal(
        vsp.dense_backtrace_plain(torch.from_numpy(bp), torch.from_numpy(last)),
        path)


@pytest.mark.parametrize("T,C,max_smem,plan", [
    (250, 80, None, (51, 3, 5)), (1000, 80, None, (51, 3, 20)), (2, 80, None, (1, 3, 1)),
    (250, 81, None, (50, 3, 5)), (37, 83, None, (36, 3, 1)), (10, 19365, None, (1, 3, 9)),
    (10, 19366, None, (0, 3, 0)), (30, 9, 480, (4, 3, 8))])
def test_dense_bt_plan(T, C, max_smem, plan):
    """The backtrace kernel's chunk of frames (about 4,096 words, at most
    T - 1), ring and chunks a sample; 0 frames (the walk from global
    memory) where three chunks of one frame do not fit."""
    args = (T, C) if max_smem is None else (T, C, max_smem)
    assert vsp.dense_bt_plan(*args) == plan


def _emulate_dense_bt(bp, last, max_smem=None):
    """``dense_backtrace`` on ``dense_bt_plan``'s ring, in numpy: chunk j
    (frames [j F, j F + F) of the sample's table) copied c-th, j = chunks -
    1 - c, into slot c mod ring at the offset of its first global word mod
    4 (a 4-byte head up to a 16-byte boundary, a body of 16-byte copies
    aligned on both sides, a 4-byte tail), then walked from its last frame,
    one load from the slot a frame.  Returns the paths and the (head,
    tail) splits seen."""
    B, Tm1, C = bp.shape
    F, R, nck = vsp.dense_bt_plan(Tm1 + 1, C, *(() if max_smem is None else (max_smem,)))
    words = bp.reshape(-1)
    path = np.full((B, Tm1 + 1), -7, np.int32)
    splits = set()
    for b in range(B):
        state = int(last[b])
        path[b, Tm1] = state
        g_b = b * Tm1 * C
        if F == 0:  # the global walk
            for t in range(Tm1 - 1, -1, -1):
                state = int(words[g_b + t * C + state])
                path[b, t] = state
            continue
        slot = (F * C + 3 + 3) & ~3
        ring = np.full(R * slot, -1, np.int64)
        assert R * slot * 4 <= (max_smem or _build.MAX_SMEM)
        for c in range(nck):
            j = nck - 1 - c
            t0, t1, r = j * F, min(j * F + F, Tm1), c % R
            n = (t1 - t0) * C
            g0 = g_b + t0 * C
            head = min((4 - g0 % 4) % 4, n)
            body = (n - head) // 4
            tail = n - head - 4 * body
            dst = r * slot + g0 % 4
            ring[r * slot:(r + 1) * slot] = -1
            ring[dst:dst + head] = words[g0:g0 + head]
            assert (dst + head) % 4 == 0 and (g0 + head) % 4 == 0
            ring[dst + head:dst + head + 4 * body] = words[g0 + head:g0 + head + 4 * body]
            k = head + 4 * body
            ring[dst + k:dst + k + tail] = words[g0 + k:g0 + k + tail]
            assert dst + n <= (r + 1) * slot
            splits.add((head, tail))
            row = dst + (t1 - 1 - t0) * C
            for t in range(t1 - 1, t0 - 1, -1):
                state = int(ring[row + state])
                assert state >= 0
                path[b, t] = state
                row -= C
    return path, splits


@pytest.mark.parametrize("B,T,C,max_smem", [
    (3, 2, 80, None), (3, 38, 81, None), (5, 37, 83, None), (4, 30, 9, 480),
    (3, 30, 9, 100), (3, 250, 81, None), (8, 1000, 80, None)])
def test_dense_bt_ring_emulation_matches_plain(B, T, C, max_smem):
    """The backtrace kernel's ring, emulated, gives exactly the paths of
    ``dense_backtrace_plain`` and (up to T = 38) of JAX's Pallas kernel in
    interpret mode: T = 2, T - 1 not a multiple of the chunk's frames, odd
    C, misaligned samples and chunks (heads and tails of 1-3 words), a
    chunk of 4 frames forced by a small shared memory and the global walk
    (no room for 3 chunks of one frame)."""
    rng = np.random.RandomState(B * T + C)
    bp = rng.randint(0, C, size=(B, T - 1, C)).astype(np.int32)
    last = rng.randint(0, C, size=B).astype(np.int32)
    got, splits = _emulate_dense_bt(bp, last, max_smem)
    want = vsp.dense_backtrace_plain(torch.from_numpy(bp), torch.from_numpy(last)).numpy()
    np.testing.assert_array_equal(got, want)
    if T <= 38:
        j_path = jax_vsp.dense_backtrace(jnp.asarray(bp.transpose(1, 0, 2)), jnp.asarray(last), C)
        np.testing.assert_array_equal(got, np.asarray(j_path))
    if (T - 1) * C % 2 == 1 and max_smem != 100:
        assert any(h % 2 == 1 for h, _ in splits) and any(t > 0 for _, t in splits)


def test_dense_bt_profile_copies_match_the_kernel_source():
    """Each copy ``scripts/profile_dense_bt.py`` builds of ``csrc/viterbi.cu``
    (a part removed or changed, or ``clock64`` marks added) still finds
    every piece of source it changes exactly once, so the script runs on
    the card as it is."""
    from gtn_applications_tpu_torch.scripts import profile_dense_bt as prof

    for name, subs in dict(prof.VARIANTS, clocks=prof.CLOCKS).items():
        src = prof.patched(name, subs)
        assert all(new in src for _, new in subs), name


def test_asg_viterbi_golden():
    T, N, num_replabels = 4, 3, 1
    crit = ASG(num_classes=N, num_replabels=num_replabels, use_garbage=False)
    inputs = torch.tensor(
        [0, 0, 0, 7, 0, 5, 4, 3, 0, 5, 8, 5, 0, 5, 4, 3], dtype=torch.float32
    ).reshape(1, T, N + num_replabels)
    trans = torch.tensor(
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 2, 0, 2, 0, 0],
        dtype=torch.float32,
    ).reshape(N + num_replabels + 1, N + num_replabels)
    preds = crit.viterbi(inputs, {"transitions": trans})
    assert preds[0].tolist() == [2, 1, 0]


@pytest.mark.parametrize("num_replabels,use_garbage", [(1, True), (2, False)])
def test_asg_criterion_matches_jax(num_replabels, use_garbage):
    import jax

    rng = np.random.RandomState(num_replabels)
    num_classes, B, T = 5, 3, 16
    crit = ASG(num_classes, num_replabels, use_garbage)
    jcrit = jax_asg.ASG(num_classes, num_replabels, use_garbage)
    C = crit.N
    out = rng.randn(B, T, C).astype(np.float32)
    trans = (rng.randn(C + 1, C) * 0.5).astype(np.float32)
    targets = [[1, 1, 2], [4, 0, 0, 0], [3]]
    lens = np.array([16, 11, 7], np.int32)

    prep = crit.prepare(targets)
    jprep = jcrit.prepare(targets)
    np.testing.assert_array_equal(prep[0].numpy(), np.asarray(jprep[0]))
    params = criterion_params_from_jax({"transitions": trans})
    x = torch.from_numpy(out).requires_grad_(True)
    loss = crit.loss(params, x, prep, torch.from_numpy(lens))
    g_x, g_tr = torch.autograd.grad(loss, (x, params["transitions"]))
    j_loss, (j_gtr, j_gx) = jax.value_and_grad(
        lambda p, x: jcrit.loss(p, x, jprep, jnp.asarray(lens)), argnums=(0, 1)
    )({"transitions": jnp.asarray(trans)}, jnp.asarray(out))
    assert abs(float(loss.detach()) - float(j_loss)) < 1e-5
    np.testing.assert_allclose(g_x.numpy(), np.asarray(j_gx), atol=1e-6)
    np.testing.assert_allclose(g_tr.numpy(), np.asarray(j_gtr["transitions"]),
                               atol=1e-6)

    preds = crit.viterbi(torch.from_numpy(out), params, torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(out), {"transitions": jnp.asarray(trans)},
                            jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [p.tolist() for p in j_preds]
    assert all(p.dtype == np.int32 for p in preds)


def test_criterion_params_from_jax():
    trans = np.arange(12, dtype=np.float32).reshape(4, 3)
    params = criterion_params_from_jax({"transitions": trans}, torch.device("cpu"))
    assert params["transitions"].requires_grad
    np.testing.assert_array_equal(params["transitions"].detach().numpy(), trans)
    assert criterion_params_from_jax({}) == {}


@pytest.mark.parametrize("num_replabels,use_garbage", [(0, False), (1, True), (2, True)])
def test_native_cleanup_and_transitions_graph_match_jax(monkeypatch, num_replabels,
                                                        use_garbage):
    """The decode cleanup takes the native ``asg_collapse`` where the
    library is enabled, as JAX's does, and gives the Python ``_cleanup``'s
    tokens and JAX's exactly (runs of repeat labels, garbage, lengths past
    T and zero); ``TW_NATIVE=0`` takes the Python cleanup.
    ``create_transitions_graph`` builds JAX's graph arc for arc."""
    from gtn_applications_tpu.wfst import native as jax_native
    from gtn_applications_tpu_torch.wfst import native

    rng = np.random.RandomState(7 + num_replabels)
    crit = ASG(4, num_replabels, use_garbage)
    jcrit = jax_asg.ASG(4, num_replabels, use_garbage)
    B, T = 6, 40
    paths = rng.randint(0, crit.N, (B, T)).astype(np.int32)
    paths[0, :] = crit.N - 1
    paths[1, 5:20] = num_replabels  # a long run of one token
    lens = np.array([T, 0, 17, 1, T + 5, 33], np.int32)
    for lengths in (None, lens):
        handle = (torch.from_numpy(paths),
                  None if lengths is None else torch.from_numpy(lengths))
        native_out = crit.viterbi_finalize(handle)
        python_out = crit._cleanup(paths, lengths)
        jax_out = jcrit.viterbi_finalize((jnp.asarray(paths), lengths))
        direct = native.asg_collapse(paths, lengths, crit.garbage_idx, num_replabels)
        for outs in (python_out, jax_out, direct):
            assert [o.tolist() for o in native_out] == [o.tolist() for o in outs]
        assert all(o.dtype == np.int32 for o in native_out)
    calls = []
    monkeypatch.setattr(native, "asg_collapse", lambda *a: calls.append(a))
    crit.viterbi_finalize((torch.from_numpy(paths), torch.from_numpy(lens)))
    assert len(calls) == 1 and jax_native.available()
    monkeypatch.setenv("TW_NATIVE", "0")
    assert [o.tolist() for o in crit.viterbi_finalize((torch.from_numpy(paths), None))] \
        == [o.tolist() for o in crit._cleanup(paths, None)]
    assert len(calls) == 1

    trans = rng.randn(crit.N + 1, crit.N).astype(np.float32)
    g = asg_mod.create_transitions_graph(trans)
    j = jax_asg.create_transitions_graph(trans)
    assert (g.start, g.finals, list(g.arcs())) == (j.start, j.finals, list(j.arcs()))
    assert g.num_arcs() == crit.N * (crit.N + 1)
