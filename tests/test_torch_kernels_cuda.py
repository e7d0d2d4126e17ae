"""The port's CUDA kernel wrappers refuse what their kernels do not take.

These tests need an NVIDIA GPU; elsewhere they skip.  Each kernel is held
against its plain version on the card by ``chip_smoke.py`` (phases 3-10),
at the bench headline and at the main path's shapes.  The file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest \
        -o addopts="" -m cuda -q
"""

import pytest
import torch

from gtn_applications_tpu_torch.ops import (
    dense_scan_pallas, gathers, lattice_pallas, viterbi_scan_pallas,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(2, 3, 4, device=cuda_device)
    idx = torch.zeros(2, 5, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        gathers.gather_fwd_cuda(x.double(), idx)
    with pytest.raises(ValueError):
        gathers.gather_fwd_cuda(x, idx.cpu())
    with pytest.raises(ValueError):
        gathers.gather_bwd_cuda(torch.zeros(2, 3, 6, device=cuda_device), idx, 4)
    with pytest.raises(ValueError):  # a plan past shared memory
        gathers.gather_bwd_cuda(torch.zeros(1, 1, 20000, device=cuda_device),
                                torch.zeros(1, 20000, dtype=torch.int32, device=cuda_device), 80)
    lp = torch.zeros(2, 3, 4, device=cuda_device)
    state = torch.zeros(2, 5, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        lattice_pallas.ctc_alpha_cuda(lp, idx, state, state, lens.long())
    with pytest.raises(ValueError):
        lattice_pallas.ctc_alpha_cuda(lp, idx.long(), state, state, lens)
    with pytest.raises(ValueError):
        lattice_pallas.ctc_alpha_cuda(lp[:, :, :0], idx, state, state, lens)
    with pytest.raises(ValueError):
        lattice_pallas.ctc_grad_cuda(lp, idx, torch.zeros(2, 3, 4, device=cuda_device), state,
                                     state, lens, lens.float(), lens.float())


@pytest.mark.cuda
def test_new_cuda_wrappers_refuse_bad_inputs(cuda_device):
    bp = torch.zeros(2, 4, 3, dtype=torch.int32, device=cuda_device)
    last = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        viterbi_scan_pallas.dense_backtrace_cuda(bp.long(), last)
    with pytest.raises(ValueError):
        viterbi_scan_pallas.dense_backtrace_cuda(bp[:, :0], last)
    em = torch.zeros(2, 3, 5, device=cuda_device)
    adj = torch.zeros(2, 5, 5, device=cuda_device)
    vec = torch.zeros(2, 5, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        dense_scan_pallas.dense_scan_fwd_cuda(em, adj[:, :4], vec, vec, lens)
    with pytest.raises(ValueError):
        dense_scan_pallas.dense_scan_fwd_cuda(em, adj, vec, vec, lens.long())
    with pytest.raises(ValueError):
        dense_scan_pallas.dense_scan_bwd_cuda(em, adj, vec, vec, lens, vec.cpu())


@pytest.mark.cuda
def test_transducer_cuda_wrappers_refuse_bad_inputs(cuda_device):
    B, T, S, N, D = 2, 3, 4, 5, 2
    em = torch.zeros(B, T, S, device=cuda_device)
    adj = torch.zeros(B, S, S, device=cuda_device)
    wsel = torch.zeros(B, S, N, device=cuda_device)
    vec = torch.zeros(B, S, device=cuda_device)
    lens = torch.ones(B, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        dense_scan_pallas.factored_scan_fwd_cuda(em, adj, wsel[:, :, :4], wsel,
                                                 vec, vec, lens)
    with pytest.raises(ValueError):
        dense_scan_pallas.factored_scan_fwd_cuda(em, adj, wsel, wsel, vec, vec,
                                                 lens.long())
    with pytest.raises(ValueError):
        dense_scan_pallas.factored_scan_bwd_cuda(em, adj, wsel, wsel, vec, lens,
                                                 vec.cpu())
    src = torch.zeros(D, S, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(D, S, device=cuda_device)
    start = torch.zeros(S, device=cuda_device)
    with pytest.raises(ValueError):
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(em, src, src, w, start[:3], lens)
    with pytest.raises(ValueError):
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(em, src.long(), src, w, start, lens)
    with pytest.raises(ValueError):  # the decode's accept of the wrong size
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(em, src, src, w, start, lens,
                                                  accept=start[:3])
    with pytest.raises(ValueError):  # a walk without accept
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(em, src, src, w, start, lens, walk="shared")
    with pytest.raises(ValueError, match="walk"):
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(em, src, src, w, start, lens, accept=start,
                                                  walk="texture")


@pytest.mark.cuda
def test_sparse_cuda_wrappers_refuse_bad_inputs(cuda_device):
    from gtn_applications_tpu_torch.ops import seglse_pallas, sparse_scan_pallas

    B, T, S, A, C = 2, 3, 4, 6, 5
    src = torch.zeros(1, A, dtype=torch.int32, device=cuda_device)
    idx = seglse_pallas.arc_index(src, src + 1, S)
    alpha = torch.zeros(B, S, device=cuda_device)
    w = torch.zeros(1, A, device=cuda_device)
    with pytest.raises(ValueError):
        seglse_pallas.seg_lse_fwd_cuda(alpha[:, :3], w, w, idx)
    with pytest.raises(ValueError):
        seglse_pallas.seg_lse_fwd_cuda(alpha, w.double(), w, idx)
    with pytest.raises(ValueError):
        seglse_pallas.seg_lse_fwd_cuda(alpha, w, w[:, :3], idx)
    with pytest.raises(ValueError):
        seglse_pallas.seg_lse_bwd_cuda(alpha, w, None, idx, alpha, alpha, alpha.cpu())
    with pytest.raises(ValueError):
        seglse_pallas.seg_lse_bwd_cuda(alpha, w, None, idx, alpha[:, :3], alpha, alpha)
    em = torch.zeros(B, T, C, device=cuda_device)
    lens = torch.full((B,), T, dtype=torch.int32, device=cuda_device)
    empty = torch.zeros(1, 0, dtype=torch.int32, device=cuda_device)
    plan = sparse_scan_pallas.scan_plan(src, src + 1, src, empty, empty, S, C)
    with pytest.raises(ValueError):
        sparse_scan_pallas.sparse_scan_fwd_cuda(em[:, :, :4], alpha, lens, plan, w,
                                                w[:, :0], 0)
    with pytest.raises(ValueError):
        sparse_scan_pallas.sparse_scan_fwd_cuda(em, alpha, lens.long(), plan, w,
                                                w[:, :0], 0)
    cpu_plan = plan._replace(main=None)
    with pytest.raises(ValueError):
        sparse_scan_pallas.sparse_scan_fwd_cuda(em, alpha, lens, cpu_plan, w, w[:, :0], 0)
    with pytest.raises(ValueError):
        sparse_scan_pallas.sparse_scan_bwd_cuda(em, torch.zeros(B, T, S, device=cuda_device),
                                                lens, plan, w, w[:, :0], 0, alpha)


@pytest.mark.cuda
def test_segmax_cuda_wrapper_refuses_bad_inputs(cuda_device):
    from gtn_applications_tpu_torch.ops import seglse_pallas, segmax_pallas

    B, S, A, C = 2, 4, 6, 5
    src = torch.zeros(1, A, dtype=torch.int32, device=cuda_device)
    label = torch.zeros(1, A, dtype=torch.int32, device=cuda_device)
    idx = seglse_pallas.arc_index(src, src + 1, S, label, C)
    alpha = torch.zeros(B, S, device=cuda_device)
    w = torch.zeros(1, A, device=cuda_device)
    row = torch.zeros(B, C, device=cuda_device)
    with pytest.raises(ValueError):
        segmax_pallas.seg_max_cuda(alpha[:, :3], w, row, idx)
    with pytest.raises(ValueError):
        segmax_pallas.seg_max_cuda(alpha, w.double(), row, idx)
    with pytest.raises(ValueError):
        segmax_pallas.seg_max_cuda(alpha, w, row.cpu(), idx)
    with pytest.raises(ValueError):
        segmax_pallas.seg_max_cuda(alpha, w, row[:1], idx)
    per_arc = seglse_pallas.arc_index(src, src + 1, S)
    with pytest.raises(ValueError):
        segmax_pallas.seg_max_cuda(alpha, w, row, per_arc)


@pytest.mark.cuda
def test_sparse_scan_wrappers_refuse_bad_cluster_sizes(cuda_device):
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas

    B, T, S, A, C = 2, 3, 4, 6, 5
    src = torch.zeros(1, A, dtype=torch.int32, device=cuda_device)
    empty = torch.zeros(1, 0, dtype=torch.int32, device=cuda_device)
    plan = sparse_scan_pallas.scan_plan(src, src + 1, src, empty, empty, S, C)
    em = torch.zeros(B, T, C, device=cuda_device)
    alpha = torch.zeros(B, S, device=cuda_device)
    lens = torch.full((B,), T, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(1, A, device=cuda_device)
    traj = torch.zeros(B, T + 1, S, device=cuda_device)
    for k in (0, 3, 16):
        with pytest.raises(ValueError, match="cluster size"):
            sparse_scan_pallas.sparse_scan_fwd_cuda(em, alpha, lens, plan, w, w[:, :0], 0,
                                                    cluster=k)
        with pytest.raises(ValueError, match="cluster size"):
            sparse_scan_pallas.sparse_scan_bwd_cuda(em, traj, lens, plan, w, w[:, :0], 0,
                                                    alpha, cluster=k)


@pytest.mark.cuda
def test_segmax_scan_cuda_wrapper_refuses_bad_inputs(cuda_device):
    from gtn_applications_tpu_torch.ops import segmax_pallas, sparse_scan_pallas

    B, T, S, A, C = 2, 3, 4, 6, 5
    src = torch.zeros(1, A, dtype=torch.int32, device=cuda_device)
    plan = sparse_scan_pallas.scan_plan(src, src + 1, src, src[:, :0], src[:, :0], S, C)
    args = dict(em=torch.zeros(B, T, C, device=cuda_device),
                w_s=torch.zeros(1, A, device=cuda_device),
                start=torch.zeros(S, device=cuda_device),
                accept=torch.zeros(S, device=cuda_device),
                lens=torch.full((B,), T, dtype=torch.int32, device=cuda_device), plan=plan)
    em, lens = args["em"], args["lens"]
    for bad in (dict(em=em[:, :, :4]), dict(em=em.double()), dict(em=em[:, :0]),
                dict(em=em.cpu()), dict(lens=lens.long()), dict(start=args["start"][:3]),
                dict(w_s=args["w_s"].double()), dict(plan=plan._replace(main=None)),
                dict(cluster=0), dict(cluster=3), dict(cluster=16)):
        with pytest.raises(ValueError):
            segmax_pallas.seg_max_scan_cuda(**dict(args, **bad))


@pytest.mark.cuda
def test_viterbi_scan_routes_match_plain_and_refuse(cuda_device):
    """The whole-scan Viterbi's forward kernel equals its plain version
    bitwise by each route and with two arcs a lane (hub chunks), on a
    random plan with integer weights (exact ties) and an isolated state;
    a route that does not fit, 2^16 channels and a packed list on the
    host raise."""
    import numpy as np

    from gtn_applications_tpu_torch.ops.semiring import NEG
    from gtn_applications_tpu_torch.ops.sparse import ArcTable

    rng = np.random.RandomState(3)
    S, C, B, T = 12, 5, 4, 20
    dst = np.concatenate([np.full(90, 0), rng.randint(1, S - 1, 60)]).astype(np.int32)
    src = rng.randint(0, S, dst.size).astype(np.int32)
    start = np.full(S, NEG, np.float32)
    start[:2] = 0.0
    z = torch.zeros(0, dtype=torch.int32)
    table = ArcTable(torch.from_numpy(src), torch.from_numpy(dst),
                     torch.from_numpy(rng.randint(0, C, dst.size).astype(np.int32)),
                     torch.from_numpy(rng.randint(-1, 2, dst.size).astype(np.float32)),
                     torch.from_numpy(start), torch.zeros(S), z, z, torch.zeros(0))
    plan = viterbi_scan_pallas.build_plan(table)
    src_b, lab_b, w_b, st, _ = plan.to(cuda_device)
    em = torch.from_numpy(rng.randint(-1, 2, (B, T, C)).astype(np.float32)).to(cuda_device)
    lens = torch.tensor([T, T - 3, 1, 0], dtype=torch.int32, device=cuda_device)
    want = viterbi_scan_pallas.viterbi_scan_fwd_plain(em, src_b, lab_b, w_b, st, lens)
    for cap in (None, 2):
        packed = plan.packed(cuda_device, cap)
        assert packed.hubs == (0 if cap is None else 1)
        for route in viterbi_scan_pallas.ROUTES:
            if not viterbi_scan_pallas.route_fits(packed, S, C, route):
                with pytest.raises(ValueError, match="does not fit"):
                    viterbi_scan_pallas.viterbi_scan_fwd_cuda(
                        em, src_b, lab_b, w_b, st, lens, packed=packed, route=route)
                continue
            got = viterbi_scan_pallas.viterbi_scan_fwd_cuda(
                em, src_b, lab_b, w_b, st, lens, packed=packed, route=route)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (cap, route)
    with pytest.raises(ValueError):
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(
            em, src_b, lab_b, w_b, st, lens, packed=plan.packed("cpu"))
    with pytest.raises(ValueError, match="does not fit"):  # labels past the rows
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(
            em[:, :, :2].contiguous(), src_b, lab_b, w_b, st, lens,
            packed=plan.packed(cuda_device))
    wide = torch.zeros(1, 1, 2**16, device=cuda_device)
    with pytest.raises(ValueError, match="2\\^16"):
        viterbi_scan_pallas.viterbi_scan_fwd_cuda(wide, src_b, lab_b, w_b, st, lens[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "long"])
def test_viterbi_decode_routes_match_plain(cuda_device, case):
    """The decode (scan and walk in one launch) by each route and each walk
    that fits beside it, against the plain scan and backtrace
    (``chip_smoke.hold_viterbi_kernels``): slots and labels bitwise, final
    alphas and scores within 1e-6; "ties": integer weights and emissions
    (exact ties in the scan and the argmax), at one arc a lane (hub
    chunks) too; "long": T = 720, where the walk words fit only in the
    global scratch (walk "chunked")."""
    import chip_smoke

    vsp = viterbi_scan_pallas
    if case == "ties":
        inputs = chip_smoke.viterbi_headline_inputs(torch, cuda_device, b=6, t=60, seed=8,
                                                    integer=True)
        S, C = inputs[4].shape[0], inputs[0].shape[2]
        for cap in (None, 1):
            packed = vsp.pack_buckets(*inputs[1:4], cap).to(cuda_device)
            routes = [r for r in vsp.ROUTES if vsp.route_fits(packed, S, C, r)]
            chip_smoke.hold_viterbi_kernels(torch, *inputs, (case, cap), routes=routes,
                                            packed=packed, need_ties=True, walks=vsp.WALKS)
        return
    inputs = chip_smoke.viterbi_headline_inputs(torch, cuda_device, b=3, t=720)
    packed = vsp.pack_buckets(*inputs[1:4]).to(cuda_device)
    S = inputs[4].shape[0]
    route = vsp.scan_route(packed, S, chip_smoke.N, "chunked", 720)
    assert vsp.walk_route(packed, S, 720, chip_smoke.N, route) == "chunked"
    chip_smoke.hold_viterbi_kernels(torch, *inputs, case, packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,l,infeasible", [
    (4, 20, 1, False), (4, 40, 15, False), (4, 60, 22, False), (6, 120, 44, False),
    (6, 120, 44, True),
    (4, 150, 63, False), (3, 300, 127, False), (3, 300, 128, False), (2, 500, 200, False),
    (2, 900, 700, False),
])
def test_ctc_grad_routes_match_plain(cuda_device, b, t, l, infeasible):
    """The CTC backward by route "warp" (S = 3 and 31) and "block" (S = 45,
    89 with and without an infeasible sample, 127, 255 and 257 at 2-9
    warps, 401 at 13, 1,401 at 32 with two states a thread) against
    ``ctc_grad_plain`` within 1e-5 (``chip_smoke.hold_ctc_kernels``, the
    forward with it)."""
    import chip_smoke

    args = chip_smoke.ctc_case(torch, cuda_device, b, t, l, seed=l, infeasible=infeasible)
    chip_smoke.hold_ctc_kernels(torch, *args, (b, t, l, infeasible))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,l", [(5, 20, 1), (5, 40, 11), (5, 60, 16), (6, 120, 44),
                                   (5, 300, 200), (5, 900, 700)])
def test_ctc_alpha_routes_match_plain(cuda_device, b, t, l):
    """The CTC forward by route "warp" (S = 3 and 23, one warp) and "block"
    (S = 33 at 2 warps, 89 at 3, 401 at 13, 1,401 at 32 with two states a
    thread), each batch with a zero-length sample, one of length 1 and,
    past one label, an infeasible one, against ``ctc_alpha_plain`` within
    atol 1e-3 + rtol 1e-5 on live states, the score likewise
    (``chip_smoke.hold_ctc_kernels``, the backward with it)."""
    import chip_smoke

    lp, labels, start, accept, skip, il, g = chip_smoke.ctc_case(
        torch, cuda_device, b, t, l, seed=l + 1, infeasible=l > 1)
    il = il.clone()
    il[3], il[4] = 0, 1
    route = lattice_pallas.alpha_plan(labels.shape[1])
    assert route[0] == ("warp" if labels.shape[1] <= 32 else "block")
    chip_smoke.hold_ctc_kernels(torch, lp, labels, start, accept, skip, il, g,
                                (b, t, l, route))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 11, 44, 200])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_ctc_kernels_read_lp_by_label_as_the_gather(cuda_device, l, out_of_range):
    """The CTC pair reading the log-probabilities by label (C = 80) at S =
    3, 23, 89 and 401, bitwise equal to the pair fed the gathered emissions
    with identity labels, alpha, score and grad, and with one state's label
    outside [0, C) in each sample (em 0 there, the gather's rule); its
    gradient's sum by label deterministic (``chip_smoke.hold_ctc_kernels``)."""
    import chip_smoke

    lp, labels, start, accept, skip, il, g = chip_smoke.ctc_case(
        torch, cuda_device, 4, 60 if l < 200 else 420, l, seed=l + 7)
    if out_of_range:
        labels = labels.clone()
        labels[:, 2 * l - 1 if l > 1 else 1] = lp.shape[2] + 3
        labels[1, 0] = -1
    chip_smoke.hold_ctc_kernels(torch, lp, labels, start, accept, skip, il, g,
                                (l, out_of_range))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,s,offset", [
    (32, 250, 80, 89, 0), (32, 250, 80, 44, 0), (8, 250, 80, 4096, 0), (2, 37, 201, 5003, 0),
    (3, 37, 11, 13, 1), (3, 40, 11, 13, 3), (2, 40, 80, 16000, 0), (2, 40, 50000, 100, 0),
    (2, 5, 7, 21, 2),
])
def test_gather_bwd_is_deterministic_by_route(cuda_device, b, t, c, s, offset):
    """The gather backward by route "staged" (32 frames a tile at the CTC
    headline and ASG's shape, 10 at S = 4,096, 8 at S = 5,003; g starting
    at every offset mod 4) and "global" (S = 16,000, and C = 50,000): the
    library's plan is ``gather_bwd_plan``'s; two runs bitwise equal, within
    1e-5 of the plain version (``chip_smoke.hold_gather_bwd``)."""
    import numpy as np

    import chip_smoke

    rng = np.random.default_rng(s)
    idx = rng.integers(0, c, (b, s)).astype(np.int32)
    idx[:, 0::2] = c - 1
    idx[0, :3] = [-1, c, -5]
    flat = rng.random(offset + b * t * s).astype(np.float32)
    g = torch.from_numpy(flat).to(cuda_device)[offset:].view(b, t, s)
    g = g / g.sum(-1, keepdim=True)
    g = torch.cat([torch.zeros(offset, device=cuda_device), g.reshape(-1)])[offset:].view(b, t, s)
    assert g.is_contiguous() and (g.data_ptr() // 4) % 4 == offset % 4 or offset == 0
    idx = torch.from_numpy(idx).to(cuda_device)
    dx = gathers.gather_bwd_cuda(g, idx, c)
    dx_again = gathers.gather_bwd_cuda(g, idx, c)
    torch.cuda.synchronize()
    chip_smoke.hold_gather_bwd(torch, g, torch.where((idx >= 0) & (idx < c), idx, -1), c,
                               dx, dx_again, (b, t, c, s, offset))
    assert gathers.gather_bwd_plan(s, c)[0] == ("global" if s == 16000 or c == 50000
                                                else "staged")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [(2, 2, 80), (3, 250, 81), (8, 1000, 80), (5, 37, 83)])
def test_dense_backtrace_matches_plain(cuda_device, b, t, c):
    """The dense backtrace's ring of chunks against ``dense_backtrace_plain``,
    bitwise, on the ASG Viterbi's own backpointers: one frame, T - 1 not a
    multiple of the chunk's frames, odd C (samples misaligned in memory),
    the long case (``chip_smoke.hold_dense_bt``)."""
    import chip_smoke

    bp, last = chip_smoke.asg_headline_inputs(torch, cuda_device, b, t, c)
    chip_smoke.hold_dense_bt(torch, bp, last, (b, t, c))


def _sparse_factored_case(rng, b, t, s, n, density, dev):
    """A factored-scan case with a random sparse adjacency (each state at
    least one arc, from its predecessor), every state labelled, one start
    state, accept 0, ragged lengths."""
    import numpy as np

    adj = np.where(rng.rand(b, s, s) < density, rng.uniform(0.5, 1.5, (b, s, s)), 0.0)
    adj[:, np.arange(1, s), np.arange(s - 1)] = 1.0
    lab = np.zeros((b, s, n), np.float32)
    lab[np.arange(b)[:, None], np.arange(s)[None, :], rng.randint(0, n, (b, s))] = 1.0
    start = np.full((b, s), -1e30, np.float32)
    start[:, 0] = 0.0
    lens = rng.randint(t // 2, t + 1, b).astype(np.int32)
    to = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return (to(rng.randn(b, t, s) - 2), to(adj), to(rng.randn(b, s, n) * 0.3), to(lab),
            to(rng.randn(b, s) * 0.3), to(start), to(np.zeros((b, s))),
            torch.as_tensor(lens, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case,route,rows,chain", [
    ("sparse", "registers", "staged", "registers"),
    ("wide", "shared", "staged", "registers"),
    ("long", "shared", "ring", "shared"),
    ("dense", "shared", "staged", "shared"),
    ("dense_wide", "global", "staged", "global"),
    ("dense_odd", "global", "staged", "global"),
])
def test_factored_scan_routes_match_plain(cuda_device, case, route, rows, chain):
    """The factored pair by each of its routes (the forward's registers,
    shared and global, its emission rows staged or in the ring; the chain's
    registers, shared and global; "dense_odd" puts the chain's global arcs
    after an odd number of scratch words, where they must still load as
    8-byte pairs) against the plain versions, by
    ``chip_smoke.hold_factored_scan_kernels``: live sets equal, the
    trajectory within atol 1e-3 + rtol 1e-5, the cotangents entry by entry
    within 1e-5 of |p| + the median nonzero |p|.  The route each case
    takes is the one ``dense_scan_pallas.factored_plan`` mirrors."""
    import numpy as np

    import chip_smoke

    rng = np.random.RandomState(11)
    if case == "dense":
        inputs = chip_smoke.factored_random_inputs(torch, cuda_device, 3, 30, 96, 8)
    elif case == "dense_wide":
        inputs = chip_smoke.factored_random_inputs(torch, cuda_device, 2, 20, 160, 80)
    elif case == "dense_odd":
        inputs = chip_smoke.factored_random_inputs(torch, cuda_device, 1, 21, 161, 81)
    else:
        shape = {"sparse": (4, 40, 40, 8), "wide": (3, 40, 200, 12),
                 "long": (2, 240, 320, 12)}[case]
        inputs = _sparse_factored_case(rng, *shape, 0.01, cuda_device)
    routes = chip_smoke.factored_routes(torch, inputs[1], inputs[3], inputs[7],
                                        inputs[2].shape[2])
    assert (routes["route"], routes["rows"], routes["chain_route"]) == (
        [route], [rows], [chain]), routes
    chip_smoke.hold_factored_scan_kernels(torch, *inputs, case,
                                          all_live=case.startswith("dense"))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sss", "bbb", "sbn", "bsb"])
def test_seg_lse_kernels_match_plain_on_the_hub_case(cuda_device, layout):
    """The seg_lse pair on ``chip_smoke.seglse_case`` (hubs past a block's
    registers, every group width, empty destinations, dead sources,
    invalid endpoints) against its plain versions in float64, bitwise
    from run to run (``chip_smoke.hold_seglse``), and the autograd
    Function's gradients against the plain route's."""
    import chip_smoke
    from gtn_applications_tpu_torch.ops import seglse_pallas

    alpha, src, dst, w, em, g = chip_smoke.seglse_case(torch, cuda_device, layout, b=4,
                                                       s=1200)
    idx = seglse_pallas.arc_index(src, dst, alpha.shape[1])
    errs, _ = chip_smoke.hold_seglse(torch, alpha, src, dst, w, em, idx, g, layout)
    assert errs["seg_lse_bwd_rel"] <= 1e-5

    xs = [x.clone().requires_grad_(True) for x in (alpha, w)]
    e = None if em is None else em.clone().requires_grad_(True)
    out = seglse_pallas.seg_lse(xs[0], src, dst, xs[1], e)
    got = [out] + list(torch.autograd.grad(out, xs + ([] if e is None else [e]), g))
    # the plain versions in float64 (the wrapper's CPU route runs float32)
    em64 = 0.0 if em is None else em.double()
    out_p = seglse_pallas.seg_lse_fwd_plain(alpha.double(), src, dst, w.double(), em64)
    da_p, dc_p = seglse_pallas.seg_lse_bwd_plain(alpha.double(), src, dst, w.double(), em64,
                                                 g.double())
    want = [out_p, da_p, seglse_pallas.sum_to(dc_p, w.shape[0])]
    if em is not None:
        want.append(seglse_pallas.sum_to(dc_p, em.shape[0]))
    live = out_p > -5e29
    torch.testing.assert_close(got[0].double()[live], out_p[live], rtol=1e-5, atol=1e-3)
    for k, p in zip(got[1:], want[1:]):
        torch.testing.assert_close(k.double(), p, rtol=1e-5, atol=1e-5)


def _dense_route_case(case, dev):
    """The inputs of one dense-scan route case (``chip_smoke``'s builders)."""
    import chip_smoke

    if case == "stc":
        return chip_smoke.stc_headline_inputs(torch, dev, 4, 60, 15)
    if case == "hub":
        return chip_smoke.dense_hub_inputs(torch, dev, 3, 128)
    if case == "ring":
        return chip_smoke.stc_headline_inputs(torch, dev, 2, 300, 100)
    if case == "words":
        return chip_smoke.word_decomp_inputs(torch, dev, 4, 100)
    if case == "all_live":
        return chip_smoke.dense_random_inputs(torch, dev, 3, 30, 96)
    return chip_smoke.dense_random_inputs(torch, dev, 2, 20, 304)


@pytest.mark.cuda
@pytest.mark.parametrize("case,route,rows,chain", [
    ("stc", "registers", "staged", "registers"),
    ("hub", "shared", "staged", "registers"),
    ("ring", "registers", "ring", "registers"),
    ("words", "registers", "staged", "registers"),
    ("all_live", "shared", "staged", "shared"),
    ("all_live_wide", "global", "staged", "global"),
])
def test_dense_scan_routes_match_plain(cuda_device, case, route, rows, chain):
    """The dense pair by each of its routes (the forward's registers,
    shared and global, its emission rows staged or in the ring; the chain's
    registers, shared and global; "words" holds two rounds a warp in
    registers both ways) against the plain versions, by
    ``chip_smoke.hold_dense_scan_kernels``: live sets equal, the trajectory
    within atol 1e-3 + rtol 1e-5, dem (with and without dadj) and dadj
    entry by entry within 1e-5 of |p| + the median nonzero |p|.  The route
    each case takes is the one ``dense_scan_pallas.dense_plan`` mirrors."""
    import chip_smoke

    inputs = _dense_route_case(case, cuda_device)
    routes = chip_smoke.dense_routes(torch, inputs[1], inputs[3], inputs[5])
    assert (routes["route"], routes["rows"], routes["chain_route"]) == (
        [route], [rows], [chain]), routes
    chip_smoke.hold_dense_scan_kernels(torch, *inputs, case,
                                       all_live=case.startswith("all_live"))
