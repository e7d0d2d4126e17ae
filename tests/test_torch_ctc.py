"""The port's CTC lattice against the JAX package and the CTC goldens.

Inputs come from numpy seeds and go through ``lattice.ctc_loss`` of both
packages.  The JAX side runs ``impl="pallas"`` (its Pallas kernels in
interpret mode off-TPU) and ``impl="scan"``; the port runs ``impl="auto"``
(the kernel ``Function`` with its plain versions on CPU tensors) and
``impl="scan"``.  Tolerances: loss atol 1e-4, gradient w.r.t. the logits
atol 1e-5 (fp32 recursions over 16 frames, exp/log taken by two libraries
in another order; the kernel path's t = 0 step differs from the scan's
seeding only by fp32 rounding).  Infeasible samples (targets longer than
their frames allow) follow each JAX route with the port's own: "scan"
gives them zero gradients, the kernel route the TPU kernel's nonzero ones.

The kernels run only on the card; here their host plans
(``lattice_pallas.grad_plan`` and ``alpha_plan``) are checked, and their
layouts (K states a lane or thread, neighbours by shuffles and, on route
"block", through the edge lanes of the warp above or, for the forward,
below) are emulated in float32 with torch ops and held bitwise to
``ctc_grad_plain`` and ``ctc_alpha_plain``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions.common import pad_targets as jax_pad_targets
from gtn_applications_tpu.ops import lattice as jax_lattice
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.criterions.common import pad_targets
from gtn_applications_tpu_torch.ops import gathers, lattice
from gtn_applications_tpu_torch.ops import lattice_pallas as lp
from gtn_applications_tpu_torch.ops.semiring import NEG

PORT_IMPLS = ["auto", "scan"]


def _port_loss_and_grad(logits, targets_list, blank, impl, input_lengths=None,
                        reduction="mean"):
    x = torch.from_numpy(logits).requires_grad_(True)
    targets, lengths = pad_targets(targets_list)
    lens = None if input_lengths is None else torch.tensor(input_lengths)
    loss = lattice.ctc_loss(
        torch.log_softmax(x, dim=2), targets, lengths, blank, reduction,
        lens, impl,
    )
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("port_impl", PORT_IMPLS)
@pytest.mark.parametrize("jax_impl", ["pallas", "scan"])
def test_ctc_loss_matches_jax(jax_impl, port_impl):
    rng = np.random.RandomState(0)
    B, T, N = 4, 16, 6
    logits = rng.randn(B, T, N).astype(np.float32)
    # repeated labels (disallowed skips), an empty target, ragged lengths
    tgts = [[0, 1, 1, 2], [3], [], [2, 2, 2, 4, 0]]
    input_lengths = [16, 12, 9, 14]

    targets, lengths = jax_pad_targets(tgts)

    def loss_fn(x):
        return jax_lattice.ctc_loss(
            jax.nn.log_softmax(x, axis=2), targets, lengths, N - 1, "mean",
            jnp.asarray(input_lengths), jax_impl,
        )

    loss_j, grad_j = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    loss_t, grad_t = _port_loss_and_grad(logits, tgts, N - 1, port_impl,
                                         input_lengths)
    assert abs(loss_t - float(loss_j)) < 1e-4
    np.testing.assert_allclose(grad_t, np.asarray(grad_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_ctc_golden_table(impl):
    """The classic 5x6 CTC table: loss 3.34211 and its logit gradients."""
    T, N = 5, 6
    emissions = np.array(
        [
            0.633766, 0.221185, 0.0917319, 0.0129757, 0.0142857, 0.0260553,
            0.111121, 0.588392, 0.278779, 0.0055756, 0.00569609, 0.010436,
            0.0357786, 0.633813, 0.321418, 0.00249248, 0.00272882, 0.0037688,
            0.0663296, 0.643849, 0.280111, 0.00283995, 0.0035545, 0.00331533,
            0.458235, 0.396634, 0.123377, 0.00648837, 0.00903441, 0.00623107,
        ],
        dtype=np.float32,
    ).reshape(1, T, N)
    expected_grad = np.array(
        [
            -0.366234, 0.221185, 0.0917319, 0.0129757, 0.0142857, 0.0260553,
            0.111121, -0.411608, 0.278779, 0.0055756, 0.00569609, 0.010436,
            0.0357786, 0.633813, -0.678582, 0.00249248, 0.00272882, 0.0037688,
            0.0663296, -0.356151, 0.280111, 0.00283995, 0.0035545, 0.00331533,
            -0.541765, 0.396634, 0.123377, 0.00648837, 0.00903441, 0.00623107,
        ],
        dtype=np.float32,
    ).reshape(1, T, N)
    loss, grad = _port_loss_and_grad(
        np.log(emissions), [[0, 1, 2, 1, 0]], N - 1, impl, reduction="none"
    )
    assert abs(loss - 3.34211) < 1e-4
    np.testing.assert_allclose(grad, expected_grad, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_ctc_edge_cases(impl):
    rng = np.random.RandomState(1)
    T, N = 10, 5
    x = rng.randn(3, T, N).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(x), dim=2)

    # empty target: the only path is all blanks
    tg, ln = pad_targets([[]])
    empty = lattice.ctc_loss(lp[:1], tg, ln, N - 1, "none", impl=impl)
    assert abs(float(empty) + float(lp[0, :, N - 1].sum())) < 1e-4

    # input_lengths: padded frames past the length are ignored
    tg, ln = pad_targets([[0, 1, 2]])
    a = lattice.ctc_loss(
        torch.log_softmax(torch.from_numpy(x[:1, :7]), 2), tg, ln, N - 1,
        impl=impl,
    )
    b = lattice.ctc_loss(lp[:1], tg, ln, N - 1, input_lengths=torch.tensor([7]),
                         impl=impl)
    assert abs(float(a) - float(b)) < 1e-4

    # batched padded loss == mean of singles
    tgts = [[0, 1, 2], [3, 3], [1, 2, 3, 0, 1]]
    tg, ln = pad_targets(tgts)
    batched = lattice.ctc_loss(lp, tg, ln, N - 1, "mean", impl=impl)
    singles = [
        float(lattice.ctc_loss(lp[i:i + 1], *pad_targets([tgts[i]]), N - 1,
                               "mean", impl=impl))
        for i in range(3)
    ]
    assert abs(float(batched) - np.mean(singles)) < 1e-4


def test_ctc_viterbi_collapse_and_uniform():
    crit = CTC(blank=2)
    outputs = torch.tensor(
        [[[5, 0, 0], [5, 0, 0], [0, 0, 5], [0, 5, 0], [0, 5, 0]]],
        dtype=torch.float32,
    )
    assert crit.viterbi(outputs)[0].tolist() == [0, 1]
    assert crit.viterbi(outputs, input_lengths=torch.tensor([2]))[0].tolist() == [0]

    # uniform emissions: "ab" into 3 frames has 5 alignments
    lp = torch.full((1, 3, 3), math.log(1.0 / 3))
    loss = lattice.ctc_loss(lp, *pad_targets([[0, 1]]), 2, "none")
    assert abs(float(loss) + math.log(5 / 27)) < 1e-4


def test_ctc_unported_forms_raise():
    lp = torch.zeros(1, 4, 3)
    tg, ln = pad_targets([[0]])
    for impl in ("assoc", "chunked"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lattice.ctc_loss(lp, tg, ln, 2, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lattice.ctc_loss(torch.zeros(1, 4097, 3), tg, ln, 2)
    with pytest.raises(ValueError):
        lattice.ctc_loss(lp, tg, ln, 2, impl="pallas")


@pytest.mark.parametrize("config", [{"chunk": 256}, {"use_pt": True}])
def test_ctc_criterion_refuses_unported_options(config):
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.datasets import synthetic

    pre = synthetic.Preprocessor(None, num_features=16)
    crit, _ = utils.load_criterion("ctc", pre, {"impl": "scan"})
    assert crit.impl == "scan"
    with pytest.raises(NotImplementedError):
        utils.load_criterion("ctc", pre, config)


# two infeasible samples: [1, 1, 1, 1] needs 7 frames of 6, [2, 2, 2] needs
# 5 of 4; the third is feasible
INFEASIBLE = dict(targets=[[1, 1, 1, 1], [2, 2, 2], [0, 3]], input_lengths=[6, 4, 6])


@pytest.mark.parametrize("port_impl,jax_impl", [("auto", "pallas"), ("scan", "scan")])
def test_infeasible_samples_match_jax(port_impl, jax_impl):
    """B=3, T=6, N=5 with two infeasible samples: the losses agree on every
    route (6.666667e29 with reduction none, the batch mean of NEG's 1e30
    twice and a finite loss); the logit gradients follow each JAX route:
    the kernel route's (JAX's Pallas kernel in interpret mode) are nonzero
    on the infeasible samples (max |g| 1.90 and 1.28 here), the scan's are
    exactly 0 there."""
    rng = np.random.RandomState(7)
    B, T, N = 3, 6, 5
    logits = rng.randn(B, T, N).astype(np.float32)
    targets, lengths = jax_pad_targets(INFEASIBLE["targets"])
    lens = jnp.asarray(INFEASIBLE["input_lengths"])

    def loss_fn(x):
        return jax_lattice.ctc_loss(jax.nn.log_softmax(x, axis=2), targets, lengths, N - 1,
                                    "none", lens, jax_impl)

    loss_j, grad_j = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tg, ln = pad_targets(INFEASIBLE["targets"])
    loss_t = lattice.ctc_loss(torch.log_softmax(x, dim=2), tg, ln, N - 1, "none",
                              torch.tensor(INFEASIBLE["input_lengths"]), port_impl)
    (grad_t,) = torch.autograd.grad(loss_t, x)
    loss_t = float(loss_t.detach())
    assert abs(loss_t - float(loss_j)) < 1e-4 and loss_t > 6e29
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=0, atol=1e-5)
    dead = np.abs(grad_t.numpy()[:2])
    if port_impl == "scan":
        assert (dead == 0).all()
    else:
        assert dead.max() > 1.0 and (dead.reshape(2, -1).max(axis=1) > 0).all()


@pytest.mark.parametrize("S,plan", [(3, ("warp", 1, 2, 8)), (32, ("warp", 1, 2, 8)),
                                    (33, ("block", 1, 2, 4)), (89, ("block", 1, 3, 4)),
                                    (256, ("block", 1, 8, 4)), (257, ("block", 1, 9, 4)),
                                    (401, ("block", 1, 13, 4))])
def test_grad_plan(S, plan):
    """The backward kernel's route, states a lane K, warps a sample and
    ring of rows: a chain warp and a helper warp up to 32 states, beyond
    them a warp for each 32 states (K = ceil(S / 32 W): one state a thread
    up to 1,024 states, 16 past 8, up to the 14,528 states the wrappers
    take); past the block route's ring in shared memory the rows come from
    global memory."""
    assert lp.grad_plan(S) == plan
    assert lp.grad_plan(4096) == ("block", 4, 32, 4)
    assert lp.grad_plan(8192) == ("block", 8, 32, 0)
    assert lp.grad_plan(14528) == ("block", 16, 32, 0)


def _neighbours(x, d, route, W):
    """x [B, K, n] by thread (route "block": thread i, slot k holds state
    i + n k; route "warp": lane l, slot k holds state l K + k, stored here
    as [B, K, 32] by slot) -> the values of states s + d as the kernel
    gathers them (NEG past the last slot)."""
    B, K, n = x.shape
    lane = torch.arange(n) % 32
    neg = torch.full_like(x[:, :1], NEG)
    if route == "warp":
        # the lane's own next slots; its top d - (K - 1 - k) from the lane
        # above (lane + 2 for d = 2 when K = 1), NEG past lane 31
        out = torch.empty_like(x)
        for k in range(K):
            if k + d < K:
                out[:, k] = x[:, k + d]
            else:
                j, up = (k + d) - K, 1
                if j >= K:  # K = 1, d = 2: two lanes up
                    j, up = j - K, 2
                src = lane + up
                out[:, k] = torch.where(src < 32, x[:, j][:, src.clamp(max=31)],
                                        torch.tensor(NEG))
        return out
    # route "block": the shuffle from lane + d of one's own warp, same slot;
    # the top d lanes: lane + d - 32 of the warp above, slot k; of warp 0,
    # slot k + 1, for the last warp
    warp = torch.arange(n) // 32
    y = x[:, :, warp * 32 + (lane + d) % 32]
    up = torch.where(warp + 1 < W, warp + 1, 0) * 32 + lane + d - 32
    above = x[:, :, up.clamp(min=0)]
    nxt = torch.cat([above[:, 1:], neg], dim=1)
    above = torch.where((warp + 1 < W)[None, None, :], above, nxt)
    return torch.where((lane + d >= 32)[None, None, :], above, y)


def _emulate_grad(em, alpha, accept, skip, lens, score, g):
    """``ctc_grad`` on ``grad_plan``'s layout, in float32 torch ops: route
    "warp", the chain warp's lane l holding states l K + k (neighbours
    from the lane's own slots or the lane above), the helper's posterior
    from the beta each frame hands it; route "block", thread i of n = 32 W
    holding states i + n k (neighbours from the lane above, the top lanes'
    from the edge lanes of the warp above, or, in the last warp, from warp
    0's next slot), the posterior inline.  Each frame the posterior, eb =
    em + beta (NEG past S) and its skip mask, lse3 in the kernel's argument
    order."""
    B, T, S = em.shape
    route, K, W, _ = lp.grad_plan(S)
    n = 32 if route == "warp" else 32 * W
    pad = K * n - S

    def lay(x):  # [B, S] -> [B, K, n]: state k n + i, or (warp) l K + k
        x = torch.nn.functional.pad(x, (0, pad), value=0.0)
        return x.view(B, n, K).transpose(1, 2) if route == "warp" else x.view(B, K, n)

    def unlay(x):  # the inverse, [B, K, n] -> [B, S]
        x = x.transpose(1, 2) if route == "warp" else x
        return x.reshape(B, -1)[:, :S]

    inside = lay(torch.ones(B, S)) > 0
    skp = lay((skip > 0.5).float()) > 0
    be = torch.where(inside, lay(accept), torch.tensor(NEG))
    grads = torch.zeros(B, T, S)
    for t in reversed(range(T)):
        live = (t < lens)[:, None]
        post = torch.exp(torch.clamp(alpha[:, t] + unlay(be) - score[:, None], max=0.0))
        grads[:, t] = torch.where(live, post * g[:, None], 0.0)
        eb = torch.where(inside, lay(em[:, t]) + be, torch.tensor(NEG))
        jm = torch.where(skp, eb, torch.tensor(NEG))
        n1, n2 = _neighbours(eb, 1, route, W), _neighbours(jm, 2, route, W)
        be = torch.where(live[:, :, None], lp._lse3(eb, n1, n2), be)
    return grads


def _lattice_case(name):
    """(em, start, accept, skip, lens, target lengths) of a CTC lattice: the
    JAX-parity case of this file, the golden table, the infeasible case,
    and wider ones: a full warp (S=31), 2, 3, 4, 9 and 13 warps (S=45, 89,
    127, 257 and 401); "lengths": S=45 with lengths 0, 1, 8 and T."""
    logp, labels, start, accept, skip, lens, tl = _lattice_lp(name)
    return gathers.gather_channels_plain(logp, labels), start, accept, skip, lens, tl


def _lattice_lp(name):
    """``_lattice_case(name)`` before the gather: (log-probabilities [B, T,
    C], labels [B, S] int32, start, accept, skip, lens, target lengths)."""
    rng = np.random.RandomState(11)
    if name == "lengths":
        logp, labels, start, accept, skip, _, tl = _lattice_lp("S45")
        logp, labels, start, accept, skip, tl = (
            torch.cat([x, x]) for x in (logp, labels, start, accept, skip, tl))
        return (logp, labels, start, accept, skip, torch.tensor([0, 1, 8, 40], dtype=torch.int32),
                tl)
    if name == "jax_case":
        logits = rng.randn(4, 16, 6).astype(np.float32)
        tgts, lens = [[0, 1, 1, 2], [3], [], [2, 2, 2, 4, 0]], [16, 12, 9, 14]
    elif name == "golden":
        logits = rng.randn(1, 5, 6).astype(np.float32)
        tgts, lens = [[0, 1, 2, 1, 0]], [5]
    elif name == "infeasible":
        logits = rng.randn(3, 6, 5).astype(np.float32)
        tgts, lens = INFEASIBLE["targets"], INFEASIBLE["input_lengths"]
    else:
        L, T = {"S31": (15, 30), "S45": (22, 40), "S89": (44, 60), "S127": (63, 80),
                "S257": (128, 150),
                "S401": (200, 215)}[name]
        logits = rng.randn(2, T, 12).astype(np.float32)
        tgts = [list(rng.randint(0, 11, L)), list(rng.randint(0, 11, L // 2))]
        tgts[0][1::3] = tgts[0][0::3][:len(tgts[0][1::3])]  # repeats: skips disallowed
        lens = [T, T - 9]
    N = logits.shape[2]
    tg, tl = pad_targets(tgts)
    labels, skip_ok = lattice.ctc_state_tables(tg, N - 1)
    start, accept = lattice.ctc_start_accept(tl, labels.shape[1])
    return (torch.log_softmax(torch.from_numpy(logits), 2), labels.to(torch.int32), start, accept,
            skip_ok.to(torch.float32), torch.tensor(lens, dtype=torch.int32), tl)


def _grad_case(name):
    """(em, alpha, accept, skip, lens, score, g) of ``_lattice_case(name)``:
    route "warp" for S=31 and less, "block" at 2-13 warps beyond."""
    em, start, accept, skip, lens, tl = _lattice_case(name)
    alpha = lp.ctc_alpha_plain(em, start, skip, lens)
    score = lp._final_score(alpha[:, -1], accept)
    return em, alpha, accept, skip, lens, score, -1.0 / tl.to(torch.float32).clamp(min=1)


@pytest.mark.parametrize("name", ["jax_case", "golden", "infeasible", "S31", "S45", "S89",
                                  "S127", "S257", "S401"])
def test_grad_layout_emulation_matches_plain(name):
    """The backward kernel's layout, emulated, is bitwise
    ``ctc_grad_plain``: infeasible samples and frames past the length
    included."""
    args = _grad_case(name)
    S = args[0].shape[2]
    assert lp.grad_plan(S)[0] == ("block" if S > 32 else "warp")
    want = lp.ctc_grad_plain(*args)
    got = _emulate_grad(*args)
    assert torch.equal(got, want)
    assert (want != 0).any()


@pytest.mark.parametrize("S,plan", [(3, ("warp", 1, 1, 4)), (32, ("warp", 1, 1, 4)),
                                    (33, ("block", 1, 2, 4)), (89, ("block", 1, 3, 4)),
                                    (256, ("block", 1, 8, 4)), (257, ("block", 1, 9, 4)),
                                    (401, ("block", 1, 13, 4)), (4096, ("block", 4, 32, 4)),
                                    (8192, ("block", 8, 32, 4)), (14528, ("block", 16, 32, 0))])
def test_alpha_plan(S, plan):
    """The forward kernel's route, states a thread K, warps a sample and
    ring of em rows: a warp for each 32 states (one warp alone, no
    barrier, up to 32), K = ceil(S / 32 W), 16 past 8, up to the 14,528
    states the wrappers take; past the ring's shared memory em comes from
    global memory."""
    assert lp.alpha_plan(S) == plan


def _alpha_neighbours(a, W):
    """a [B, K, n] by thread (thread i, slot k holds state i + n k, n = 32
    W) -> (p1, p2), the values of states s - 1 and s - 2 as the forward
    kernel gathers them (NEG below state 0).  One warp: a rotation by 1
    and 2 lanes, lanes 31 and 30 sending the slot below.  More: the lanes
    1 and 2 below (shuffle up), lanes 0 and 1 from the warp below's lanes
    30 and 31 (warp 0 from the last warp's, of the slot below)."""
    B, K, n = a.shape
    lane, warp = torch.arange(n) % 32, torch.arange(n) // 32
    neg = torch.full_like(a[:, :1], NEG)
    lower = torch.cat([neg, a[:, :-1]], dim=1)  # each thread's slot k - 1
    if W == 1:
        def rotate(d):
            src = (lane - d) % 32  # the lane each lane reads
            sent = torch.where((lane >= 32 - d)[None, None, :], lower, a)
            return sent[:, :, src]
        return rotate(1), rotate(2)
    p1 = a[:, :, warp * 32 + (lane - 1).clamp(min=0)]
    p2 = a[:, :, warp * 32 + (lane - 2).clamp(min=0)]
    below = torch.where(warp > 0, warp - 1, W - 1) * 32
    up = (warp > 0)[None, None, :]
    x30 = torch.where(up, a[:, :, below + 30], lower[:, :, below + 30])
    x31 = torch.where(up, a[:, :, below + 31], lower[:, :, below + 31])
    first = (lane == 0)[None, None, :]
    p1 = torch.where(first, x31, p1)
    p2 = torch.where(first, x30, torch.where((lane == 1)[None, None, :], x31, p2))
    return p1, p2


def _emulate_alpha(em, start, skip, lens):
    """``ctc_alpha`` on ``alpha_plan``'s layout, in float32 torch ops:
    thread i of n = 32 W holding states i + n k (NEG past S), neighbours as
    ``_alpha_neighbours`` gathers them, the skip mask on the destination,
    lse3 in the kernel's argument order and em added after it.  Frames run
    in pairs from frame 1 while the first of a pair is live: a frame past
    the sample's last is computed from a clamped em row and dropped.  Only
    live frames are stored; the frozen tail is written from the state after
    the frames.  Every entry is written exactly once (NaN marks the rest)."""
    B, T, S = em.shape
    _, K, W, _ = lp.alpha_plan(S)
    n = 32 * W
    pad = K * n - S

    def lay(x):  # [B, S] -> [B, K, n]: state k n + i
        return torch.nn.functional.pad(x, (0, pad), value=0.0).view(B, K, n)

    def unlay(x):
        return x.reshape(B, -1)[:, :S]

    inside = lay(torch.ones(B, S)) > 0
    skp = lay((skip > 0.5).float()) > 0
    t_live = torch.where(lens < 1, 1, lens.clamp(max=T))
    a = torch.where(inside, lay(start + em[:, 0]), torch.tensor(NEG))
    out = torch.full((B, T, S), float("nan"))
    written = torch.zeros(B, T, dtype=torch.int32)
    out[:, 0], written[:, 0] = unlay(a), 1
    i0 = 1
    while i0 < int(t_live.max()):
        for t in (i0, i0 + 1):
            on = (t < t_live)[:, None, None]
            p1, p2 = _alpha_neighbours(a, W)
            jump = torch.where(skp, p2, torch.tensor(NEG))
            v = lay(em[:, min(t, T - 1)]) + lp._lse3(a, p1, jump)
            keep = inside & on
            for b in torch.nonzero(on[:, 0, 0]).flatten().tolist():
                out[b, t], written[b, t] = unlay(v)[b], written[b, t] + 1
            a = torch.where(keep, v, a)
        i0 += 2
    for b in range(B):
        out[b, int(t_live[b]):] = unlay(a)[b]
        written[b, int(t_live[b]):] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("name", ["jax_case", "golden", "infeasible", "S31", "S45", "S89",
                                  "S127", "S257", "S401", "lengths"])
def test_alpha_layout_emulation_matches_plain(name):
    """The forward kernel's layout, emulated, is bitwise
    ``ctc_alpha_plain``: states by strided slots, the exchange across
    warps and slots, the skip mask on the destination, frames past the
    last dropped, the frozen tail; odd and even live frames, lengths 0 and
    1, infeasible samples."""
    em, start, _, skip, lens, _ = _lattice_case(name)
    S = em.shape[2]
    assert lp.alpha_plan(S)[0] == ("block" if S > 32 else "warp")
    want = lp.ctc_alpha_plain(em, start, skip, lens)
    got = _emulate_alpha(em, start, skip, lens)
    assert torch.equal(got, want)
    assert (want > NEG / 2).any()


def test_profile_copies_match_the_kernel_source():
    """Each copy ``scripts/profile_ctc_grad.py`` builds of ``csrc/ctc.cu``
    (a part removed or changed, or ``clock64`` marks added) still finds
    every piece of source it changes exactly once, so the script runs on
    the card as it is."""
    from gtn_applications_tpu_torch.scripts import profile_ctc_grad as prof

    for name, subs in dict(prof.VARIANTS, clocks=prof.CLOCKS).items():
        src = prof.patched(name, subs)
        assert all(new in src for _, new in subs), name


class _LabelFetch:
    """em as the fused kernels read it: ``fetch[:, t]`` is row t, state s
    copied from ``lp[b, t]`` at its label clamped into [0, C) and selected
    to 0 where the label lies outside [0, C) (the register load's select).
    Stands in for em in the layout emulations, which read it by rows."""

    def __init__(self, logp, labels):
        C = logp.shape[2]
        self.logp, self.ok = logp, (labels >= 0) & (labels < C)
        self.lab = torch.where(self.ok, labels, 0).long()
        self.shape = (logp.shape[0], logp.shape[1], labels.shape[1])

    def __getitem__(self, key):
        _, t = key
        return torch.where(self.ok, torch.gather(self.logp[:, t], 1, self.lab), 0.0)


def _fused_case(name):
    """``_lattice_lp(name)`` with, for "out_of_range", S=45's labels out of
    [0, C) at two states of each sample (C + 2 and -1); and em as
    ``gather_channels_plain`` gives it, labels outside [0, C) as -1."""
    logp, labels, start, accept, skip, lens, tl = _lattice_lp(
        "S45" if name == "out_of_range" else name)
    C = logp.shape[2]
    if name == "out_of_range":
        labels = labels.clone()
        labels[:, 3], labels[:, 6] = C + 2, -1
    clean = torch.where((labels >= 0) & (labels < C), labels, -1)
    return logp, labels, gathers.gather_channels_plain(logp, clean), start, accept, skip, lens, tl


FUSED_CASES = ["jax_case", "golden", "infeasible", "S31", "S45", "S89", "S127", "S257", "S401",
               "lengths", "out_of_range"]


@pytest.mark.parametrize("name", FUSED_CASES)
def test_alpha_layout_emulation_reads_lp_by_label(name):
    """The forward kernel's layout, emulated, fed the log-probabilities and
    labels through the fused fetch (the label in a register, the copy at
    the clamped label, 0 selected outside [0, C)), is bitwise
    ``gather_channels_plain`` then ``ctc_alpha_plain``."""
    logp, labels, em, start, _, skip, lens, _ = _fused_case(name)
    want = lp.ctc_alpha_plain(em, start, skip, lens)
    got = _emulate_alpha(_LabelFetch(logp, labels), start, skip, lens)
    assert torch.equal(got, want)
    assert (want > NEG / 2).any()


@pytest.mark.parametrize("name", FUSED_CASES)
def test_grad_layout_emulation_reads_lp_by_label(name):
    """The backward kernel's layout, emulated, fed the log-probabilities and
    labels through the fused fetch, is bitwise ``gather_channels_plain``
    then ``ctc_grad_plain``; summed by label (the backward's last launch),
    bitwise ``gather_channels_bwd_plain``."""
    logp, labels, em, start, accept, skip, lens, tl = _fused_case(name)
    alpha = lp.ctc_alpha_plain(em, start, skip, lens)
    score = lp._final_score(alpha[:, -1], accept)
    g = -1.0 / tl.to(torch.float32).clamp(min=1)
    want = lp.ctc_grad_plain(em, alpha, accept, skip, lens, score, g)
    got = _emulate_grad(_LabelFetch(logp, labels), alpha, accept, skip, lens, score, g)
    assert torch.equal(got, want)
    assert (want != 0).any()
    C = logp.shape[2]
    clean = torch.where((labels >= 0) & (labels < C), labels, -1)
    assert torch.equal(gathers.gather_channels_bwd_plain(got, clean, C),
                       gathers.gather_channels_bwd_plain(want, clean, C))


def test_ctc_score_kernel_from_log_probs_matches_jax():
    """``ctc_score_kernel`` on the log-probabilities and the state labels
    (its CPU route: the gather, the plain recursions, the sum by label)
    against JAX's ``ctc_forward_score`` with its Pallas kernels in
    interpret mode: the scores within 1e-4, the gradient with respect to
    the log-probabilities within 1e-5 (tolerances of this file's
    parity test)."""
    rng = np.random.RandomState(3)
    B, T, N = 4, 16, 6
    logits = rng.randn(B, T, N).astype(np.float32)
    tgts, input_lengths = [[0, 1, 1, 2], [3], [], [2, 2, 2, 4, 0]], [16, 12, 9, 14]
    cot = rng.rand(B).astype(np.float32) - 0.5
    targets_j, lengths_j = jax_pad_targets(tgts)
    logp_j = jax.nn.log_softmax(jnp.asarray(logits), axis=2)
    score_j, vjp = jax.vjp(
        lambda x: jax_lattice.ctc_forward_score(x, targets_j, lengths_j, N - 1,
                                                jnp.asarray(input_lengths), "pallas"),
        logp_j)
    (dlp_j,) = vjp(jnp.asarray(cot))

    tg, tl = pad_targets(tgts)
    labels, skip_ok = lattice.ctc_state_tables(tg, N - 1)
    start, accept = lattice.ctc_start_accept(tl, labels.shape[1])
    logp = torch.from_numpy(np.array(logp_j)).requires_grad_(True)
    score = lp.ctc_score_kernel(logp, labels, start, accept, skip_ok,
                                torch.tensor(input_lengths))
    score.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(score_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(logp.grad.numpy(), np.asarray(dlp_j), rtol=0, atol=1e-5)
    assert logp.grad.shape == (B, T, N)
