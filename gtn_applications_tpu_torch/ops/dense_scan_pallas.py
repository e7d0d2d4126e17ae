"""Whole-scan dense-adjacency lattice recursions with hand-written VJPs.

Counterpart of ``dense_scan`` and ``factored_scan`` in
``gtn_applications_tpu/ops/dense_scan_pallas.py`` (Pallas kernels
``_fwd_kernel`` / ``_bwd_kernel`` and ``_fact_fwd_kernel`` /
``_fact_bwd_kernel``).  The module keeps the JAX file's name; the kernels
are CUDA C++ for Hopper (``csrc/dense_scan.cu``).  ``factored_scan`` is
described at its section below.

Recursion (frame 0 always applied; frames t >= len keep alpha):

    t = 0 : e = exp(min(start, 0)) * (start > NEG/2)
    t > 0 : sh = max(max(alpha), NEG) (no gradient), e = exp(alpha - sh)
    z[u]  = sum_s adj_exp[u, s] * e[s]
    new   = em_state[t] + sh + log(max(z, 1e-37))  where (z >= FLT_MIN) & has_lab
            else NEG

(a sum below the least normal float32 is dead, as on JAX's devices, which
flush denormals to zero; the floor then only bounds normal sums).

``dense_scan`` returns the final alpha; its backward replays the
trajectory in reverse, recomputing ``z``, and gives cotangents to
``em_state`` and (only when it needs one) ``adj_exp``; ``start``,
``has_lab`` and ``lengths`` are prepared data and get none.  The layout is
``[B, T, S]`` with S unpadded: the TPU's ``[T, B, S]`` transpose and its
128-lane padding existed only for its tiling.  The CUDA kernels work on
the adjacency's real arcs, which they compact in the kernel, with lanes
matched to degree: the forward one launch, the backward a statistics pass
and a chain by source (and a dadj pass when asked); ``dense_plan`` mirrors
their schedule on the host for logs and tests.
"""

import torch

from . import _build
from .semiring import NEG

# as the JAX module (and ops/factored.py): a normal fp32 number, so log z
# bottoms out at -85, not at the CTC kernels' -69
_FLOOR = 1e-37
# the least normal float32: a sum below it is dead, as on JAX's devices,
# which flush denormals to zero; kept alive, the floor above would lift it
# to e^-85 of its shift, a frame at a time (csrc/dense_scan.cu: kTiny)
_TINY = torch.finfo(torch.float32).tiny


def _exp(x):
    """exp(x) with a result below the least normal float32 flushed to 0,
    as JAX's devices flush it (csrc/dense_scan.cu: exp_ftz)."""
    e = torch.exp(x)
    return torch.where(e >= _TINY, e, 0.0)


def _start_e(start):
    return _exp(torch.clamp(start, max=0.0)) * (start > NEG / 2)


def _bmv(adj, e):
    """z[b, u] = sum_s adj[b, u, s] * e[b, s]."""
    return torch.bmm(adj, e[:, :, None])[:, :, 0]


def _bmv_t(adj, g):
    """w[b, s] = sum_u adj[b, u, s] * g[b, u]."""
    return torch.bmm(g[:, None, :], adj)[:, 0, :]


def dense_scan_fwd_plain(em_state, adj_exp, start, has_lab, lengths):
    """The alpha trajectory [B, T, S], frame by frame."""
    B, T, _ = em_state.shape
    lab = has_lab > 0.0
    lens = lengths.view(B, 1)
    z = _bmv(adj_exp, _start_e(start))
    alpha = torch.where((z >= _TINY) & lab,
                        em_state[:, 0] + torch.log(torch.clamp(z, min=_FLOOR)), NEG)
    traj = [alpha]
    for t in range(1, T):
        sh = torch.clamp(torch.amax(alpha, dim=1, keepdim=True), min=NEG)
        z = _bmv(adj_exp, _exp(alpha - sh))
        new = torch.where((z >= _TINY) & lab,
                          em_state[:, t] + sh + torch.log(torch.clamp(z, min=_FLOOR)),
                          NEG)
        alpha = torch.where(t < lens, new, alpha)
        traj.append(alpha)
    return torch.stack(traj, dim=1)


def dense_scan_bwd_plain(traj, adj_exp, start, has_lab, lengths, g_final,
                         need_dadj=True):
    """(dem [B, T, S], dadj [B, S, S] or None) from the cotangent of the
    final alpha, replaying the recursion in reverse."""
    B, T, S = traj.shape
    lab = has_lab > 0.0
    lens = lengths.view(B, 1)
    g = g_final
    dem = [None] * T
    dadj = torch.zeros_like(adj_exp) if need_dadj else None
    for t in reversed(range(T)):
        if t > 0:
            prev = traj[:, t - 1]
            sh = torch.clamp(torch.amax(prev, dim=1, keepdim=True), min=NEG)
            e = _exp(prev - sh)
        else:
            e = _start_e(start)
        z = _bmv(adj_exp, e)
        live = (t < lens) | (t == 0)
        ga = torch.where(live & (z >= _TINY) & lab, g, 0.0)
        dem[t] = ga
        dz = ga / torch.clamp(z, min=_FLOOR)
        if need_dadj:
            dadj = dadj + dz[:, :, None] * e[:, None, :]
        if t > 0:
            g = _bmv_t(adj_exp, dz) * e + torch.where(live, 0.0, g)
    return torch.stack(dem, dim=1), dadj


def _check(name, em_or_traj, adj, start, has_lab, lengths):
    _build.require_cuda(name, em_or_traj, adj, start, has_lab, lengths)
    B, T, S = em_or_traj.shape
    _build.require(f"{name} states", em_or_traj, (B, T, S), torch.float32)
    _build.require(f"{name} adj_exp", adj, (B, S, S), torch.float32)
    _build.require(f"{name} start", start, (B, S), torch.float32)
    _build.require(f"{name} has_lab", has_lab, (B, S), torch.float32)
    _build.require(f"{name} lengths", lengths, (B,), torch.int32)
    if T < 1:
        raise ValueError(f"{name} needs at least one frame")
    if not dense_fits(S):
        raise ValueError(f"{name}: the kernels' plan and rows take at most "
                         f"{DENSE_MAX_S} states, got S={S}")
    return B, T, S


def dense_scan_fwd_cuda(em_state, adj_exp, start, has_lab, lengths):
    """Launch ``dense_scan_fwd``: em_state [B, T, S], adj_exp [B, S, S],
    start/has_lab [B, S] float32, lengths [B] int32 -> traj [B, T, S]."""
    B, T, S = _check("dense_scan_fwd", em_state, adj_exp, start, has_lab, lengths)
    traj = torch.empty((B, T, S), dtype=torch.float32, device=em_state.device)
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(em_state.device):
        err = lib.dense_scan_fwd(
            em_state.data_ptr(), adj_exp.data_ptr(), start.data_ptr(),
            has_lab.data_ptr(), lengths.data_ptr(), traj.data_ptr(),
            B, T, S, _build.MAX_SMEM, _build.stream_handle(em_state),
        )
    _build.check(lib, err, "dense_scan_fwd")
    _build.LAUNCHES["dense_scan_fwd"] += 1
    return traj


def dense_scan_bwd_cuda(traj, adj_exp, start, has_lab, lengths, g_final,
                        need_dadj=True):
    """Launch ``dense_scan_bwd`` (the statistics pass and the chain, and the
    dadj pass with ``need_dadj``): traj [B, T, S], adj_exp [B, S, S],
    start/has_lab/g_final [B, S] float32, lengths [B] int32 ->
    (dem [B, T, S], dadj [B, S, S] or None)."""
    B, T, S = _check("dense_scan_bwd", traj, adj_exp, start, has_lab, lengths)
    _build.require_cuda("dense_scan_bwd", traj, g_final)
    _build.require("dense_scan_bwd g_final", g_final, (B, S), torch.float32)
    dem = torch.empty((B, T, S), dtype=torch.float32, device=traj.device)
    dadj = torch.empty_like(adj_exp) if need_dadj else None
    scratch = torch.empty(_dense_scratch_words(B, T, S, need_dadj), dtype=torch.float32,
                          device=traj.device)
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(traj.device):
        err = lib.dense_scan_bwd(
            traj.data_ptr(), adj_exp.data_ptr(), start.data_ptr(),
            has_lab.data_ptr(), lengths.data_ptr(), g_final.data_ptr(),
            dem.data_ptr(), dadj.data_ptr() if need_dadj else None,
            scratch.data_ptr(), B, T, S, _build.MAX_SMEM, _build.stream_handle(traj),
        )
    _build.check(lib, err, "dense_scan_bwd")
    _build.LAUNCHES["dense_scan_bwd"] += 1
    return dem, dadj


class _DenseScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em_state, adj_exp, start, has_lab, lengths):
        em_state = em_state.to(torch.float32).contiguous()
        adj_exp = adj_exp.to(torch.float32).contiguous()
        start = start.to(torch.float32).contiguous()
        has_lab = has_lab.to(torch.float32).contiguous()
        lengths = lengths.to(device=em_state.device, dtype=torch.int32).contiguous()
        if _build.on_cuda(em_state):
            traj = dense_scan_fwd_cuda(em_state, adj_exp, start, has_lab, lengths)
        else:
            traj = dense_scan_fwd_plain(em_state, adj_exp, start, has_lab, lengths)
        ctx.save_for_backward(traj, adj_exp, start, has_lab, lengths)
        return traj[:, -1].clone()

    @staticmethod
    def backward(ctx, g_final):
        traj, adj_exp, start, has_lab, lengths = ctx.saved_tensors
        g_final = g_final.to(torch.float32).contiguous()
        need_dadj = ctx.needs_input_grad[1]
        if _build.on_cuda(traj):
            dem, dadj = dense_scan_bwd_cuda(traj, adj_exp, start, has_lab,
                                            lengths, g_final, need_dadj)
        else:
            dem, dadj = dense_scan_bwd_plain(traj, adj_exp, start, has_lab,
                                             lengths, g_final, need_dadj)
        return dem, dadj, None, None, None


def dense_scan(em_state, adj_exp, start, has_lab, lengths):
    """Final alpha [B, S] of the dense-adjacency recursion.

    Args:
      em_state: [B, T, S] per-state emissions.
      adj_exp: [B, S, S] — adj_exp[b, u, s] = sum over arcs s -> u of e^w.
      start: [B, S] 0-or-NEG start potentials.
      has_lab: [B, S] {0, 1}: states that may hold mass.
      lengths: [B] int input lengths (frame 0 is applied even at 0).
    Differentiable in ``em_state`` and ``adj_exp``.
    """
    return _DenseScan.apply(em_state, adj_exp, start, has_lab, lengths)


# ---------------------------------------------------------------------
# Transition-factored (bigram) recursion, the scorer of
# ``factored.factored_lattice_score``:
#
#   t = 0 : z = adj_exp @ exp(min(start, 0)) * (start > NEG/2)
#           alpha = (z >= FLT_MIN) & has ? (em_state + ws_state) + log(max(z, floor))
#                                 : NEG
#   t > 0 : v[s, l] = alpha[s] + wsel[s, l],  sh[l] = max(max_s v, NEG)
#           z[u, l] = sum_s adj_exp[u, s] exp(v[s, l] - sh[l])
#           m = z >= FLT_MIN ? sh + log(max(z, floor)) : NEG
#           alpha[u] = has[u] ? em_state[t, u] + m[u, l_u] : NEG
#
# (frames t >= len keep alpha) where has[u] = lab_oh[u] is not all zero and
# l_u is u's one in-label.  The plain versions compute that literally, the
# full [S, S] x [S, N] product each frame as the TPU kernel does; the CUDA
# kernels only the column l_u of each row, over its real arcs, with the
# same per-label shift (``csrc/dense_scan.cu``).
# Cotangents go to em_state, adj_exp (when it needs one), wsel and
# ws_state; lab_oh, start and lengths are prepared data and get none.
# ---------------------------------------------------------------------


def factored_scan_fwd_plain(em_state, adj_exp, wsel, lab_oh, ws_state, start,
                            lengths):
    """The alpha trajectory [B, T, S], frame by frame."""
    B, T, _ = em_state.shape
    has = torch.sum(lab_oh, dim=-1) > 0.0
    lens = lengths.view(B, 1)
    z = _bmv(adj_exp, _start_e(start))
    alpha = torch.where((z >= _TINY) & has,
                        em_state[:, 0] + ws_state
                        + torch.log(torch.clamp(z, min=_FLOOR)), NEG)
    traj = [alpha]
    for t in range(1, T):
        v = alpha[:, :, None] + wsel                          # [B, S, N]
        sh = torch.clamp(torch.amax(v, dim=1, keepdim=True), min=NEG)
        z = torch.bmm(adj_exp, _exp(v - sh))             # [B, S, N]
        m = torch.where(z >= _TINY, sh + torch.log(torch.clamp(z, min=_FLOOR)), NEG)
        pick = torch.sum(m * lab_oh, dim=-1)
        new = torch.where(has, em_state[:, t] + pick, NEG)
        alpha = torch.where(t < lens, new, alpha)
        traj.append(alpha)
    return torch.stack(traj, dim=1)


def factored_scan_bwd_plain(traj, adj_exp, wsel, lab_oh, start, lengths,
                            g_final, need_dadj=True):
    """(dem [B, T, S], dadj [B, S, S] or None, dwsel [B, S, N], dws [B, S])
    from the cotangent of the final alpha, replaying the recursion in
    reverse."""
    B, T, S = traj.shape
    has = torch.sum(lab_oh, dim=-1) > 0.0
    lens = lengths.view(B, 1)
    g = g_final
    dem = [None] * T
    dadj = torch.zeros_like(adj_exp) if need_dadj else None
    dwsel = torch.zeros_like(wsel)
    for t in reversed(range(1, T)):
        v = traj[:, t - 1, :, None] + wsel
        sh = torch.clamp(torch.amax(v, dim=1, keepdim=True), min=NEG)
        E = _exp(v - sh)
        z = torch.bmm(adj_exp, E)
        live = t < lens
        ga = torch.where(live & has, g, 0.0)
        dem[t] = ga
        dz = torch.where(z >= _TINY,
                         ga[:, :, None] * lab_oh / torch.clamp(z, min=_FLOOR), 0.0)
        if need_dadj:
            dadj = dadj + torch.bmm(dz, E.transpose(1, 2))
        dv = torch.bmm(adj_exp.transpose(1, 2), dz) * E
        dwsel = dwsel + dv
        g = torch.sum(dv, dim=-1) + torch.where(live, 0.0, g)
    e = _start_e(start)
    z = _bmv(adj_exp, e)
    ga = torch.where((z >= _TINY) & has, g, 0.0)
    dem[0] = ga
    if need_dadj:
        dadj = dadj + (ga / torch.clamp(z, min=_FLOOR))[:, :, None] * e[:, None, :]
    return torch.stack(dem, dim=1), dadj, dwsel, ga


def label_index(lab_oh):
    """Each state's in-label [B, S] int32: the one-hot's index, -1 for a
    zero row."""
    has = torch.sum(lab_oh, dim=-1) > 0.0
    return torch.where(has, torch.argmax(lab_oh, dim=-1), -1).to(torch.int32)


# The factored kernels' schedule (csrc/dense_scan.cu), mirrored so that the
# wrappers size their scratch and a run can log the routes each sample
# takes: blocks of FACT_WARPS warps; a member of in-degree n gets a group of
# g lanes, g the least power of two with n <= g FACT_CAP (at most 32), the
# largest of its round's; a round holds at most SHIFT_GROUPS slots (8 lanes
# a slot's shift); a warp holding at most REG_ROUNDS rounds keeps its tasks
# and wsel entries in registers where S <= 8 REG_K; rings of RING rows.
FACT_WARPS = 16
FACT_CAP = 4
REG_ROUNDS = 1
SHIFT_GROUPS = 4
REG_K = 20
RING = 8


def _fact_arena(S, N, vec):
    """Word offset of the arena in ``fact_layout`` (csrc/dense_scan.cu)."""
    L = min(S, N)
    words = N + L + S + 8 + (L + 1) + S + (S + 1) + 2 * S + FACT_WARPS + 1
    words += L * S + vec
    return (words + 3) & ~3


def group_width(deg):
    """Lanes of a group serving ``deg`` arcs: the least power of two g with
    deg <= g FACT_CAP, at most 32."""
    g = 1
    while g < 32 and g * FACT_CAP < deg:
        g <<= 1
    return g


def compact_members(lab_idx_b):
    """(label_of, jslot, members): label slots in order of first use, each
    state's slot (-1 for none), and the labelled states slot by slot in
    increasing index (the kernels' member order)."""
    label_of, jslot = [], []
    for lab in lab_idx_b.tolist():
        if lab < 0:
            jslot.append(-1)
            continue
        if lab not in label_of:
            label_of.append(lab)
        jslot.append(label_of.index(lab))
    members = [u for j in range(len(label_of)) for u in range(len(jslot)) if jslot[u] == j]
    return label_of, jslot, members


def dest_rounds(deg_by_member, jslot, members, warps=FACT_WARPS, shift_cost=None):
    """The forward's rounds (``plan_dest_rounds``): members in member order
    packed into rounds (m0, m1, g) of at most SHIFT_GROUPS consecutive slots
    and 32 lanes, g the round's largest group width; and the first round of
    each warp: one a warp to the first ones where there are no more rounds
    than warps, else contiguous ranges of about equal cost (``shift_cost`` a
    round, by default the factored kernels' shift, and the arcs a lane)."""
    if shift_cost is None:
        shift_cost = 2 * ((len(jslot) + 7) // 8) + 8
    rounds, costs = [], []
    m = 0
    while m < len(members):
        m0, j0, g, most = m, jslot[members[m]], 1, 0
        while m < len(members):
            deg = deg_by_member[m]
            gn = max(g, group_width(deg))
            if (m - m0 + 1) * gn > 32 or jslot[members[m]] - j0 >= SHIFT_GROUPS:
                break
            g, most = gn, max(most, deg)
            m += 1
        rounds.append((m0, m, g))
        costs.append(shift_cost + 3 * (-(-most // g) + 2))
    total = sum(costs)
    wbeg, cum, w = [0], 0, 0
    for r, cost in enumerate(costs):
        want = r if len(rounds) <= warps else (cum * warps // total if total > 0 else 0)
        while w < want and w < warps:
            wbeg.append(r)
            w += 1
        cum += cost
    while w < warps:
        wbeg.append(len(rounds))
        w += 1
    return rounds, wbeg


def factored_plan(adj_exp, lab_idx, lengths, N):
    """What the factored kernels do with each sample, computed on the host
    from the same inputs (for logs and tests; the kernels plan on the
    device): its real arcs into labelled states, labelled states and
    labels in use, largest in- and out-degree, the forward's route
    (registers, shared, global) and where its emission rows live (staged,
    ring), and the backward chain's route and group width."""
    words = _build.MAX_SMEM // 4
    B, S, _ = adj_exp.shape
    L = min(S, N)
    nz = (adj_exp != 0).cpu()
    plans = []
    for b in range(B):
        label_of, jslot, members = compact_members(lab_idx[b].cpu())
        rows = nz[b][members]
        deg = rows.sum(1).tolist()
        nnz = int(sum(deg))
        out_deg = int(rows.sum(0).max()) if members else 0
        arena = words - _fact_arena(S, N, 3 * S)
        dense = 2 * nnz + RING * S > arena
        _, wbeg = dest_rounds([S] * len(deg) if dense else deg, jslot, members)
        most = max(wbeg[w + 1] - wbeg[w] for w in range(FACT_WARPS))
        hub = max(deg, default=0) > 32 * FACT_CAP
        g = group_width(out_deg)
        chain_rounds = -(-S * g // 32)
        chain_arena = words - _fact_arena(S, N, 2 * S)
        plans.append(dict(
            arcs=nnz, labelled=len(members), labels=len(label_of),
            max_in_degree=int(max(deg, default=0)), max_out_degree=out_deg,
            route=("global" if dense else "registers"
                   if most <= REG_ROUNDS and S <= 8 * REG_K and not hub else "shared"),
            rows=("staged" if (0 if dense else 2 * nnz) + max(1, int(lengths[b])) * S <= arena
                  else "ring"),
            chain_route=("global" if 3 * nnz + RING * (2 * S + L) > chain_arena
                         else "registers" if -(-chain_rounds // FACT_WARPS) <= REG_ROUNDS
                         and out_deg <= g * FACT_CAP else "shared"),
            chain_group=g))
    return plans


# The dense pair's schedule (csrc/dense_scan.cu, "The plain dense
# recursion"), mirrored so that the wrappers size their scratch and a run
# can log what each sample takes.  It is the factored one with every
# labelled state in one slot: a round's fixed cost in the plan is
# DENSE_ROUND_COST, a warp holds at most DENSE_REG_ROUNDS rounds (source
# rounds) in registers, and the chain's source rounds run on at most
# FACT_WARPS - 1 warps beside its side warp, which copies the ring rows.
DENSE_REG_ROUNDS = 2
DENSE_ROUND_COST = 8


def _dense_fwd_vec(S):
    return 3 * S + 2 * FACT_WARPS


def _dense_ring_row(S):
    return 2 * S + 4


def _dense_arc_words(nnz):
    """Shared words the arcs take before the rows after them (16-byte
    aligned)."""
    return (2 * nnz + 3) & ~3


def dense_fits(S):
    """Whether the dense kernels' plans and rows fit a block's shared
    memory at S states (the forward with its ring, the statistics pass,
    the chain with its ring), and S < 2^16."""
    words = _build.MAX_SMEM // 4
    return (S < 2**16 and _fact_arena(S, 1, _dense_fwd_vec(S)) + RING * S <= words
            and _fact_arena(S, 1, (1 + FACT_WARPS) * S) <= words
            and _fact_arena(S, 1, 2 * S) + RING * _dense_ring_row(S) <= words)


DENSE_MAX_S = next(S for S in range(1, 2**16) if not dense_fits(S + 1))


def _dense_scratch_words(B, T, S, need_dadj):
    """Floats of the dense backward's scratch (``dense_scan_bwd``): sh
    [B, T], rz [B, T, S], the slots [B, S], with dadj dz [B, T, S]; and,
    from an even offset, 2 S^2 a sample for the chain's arcs where a dense
    adjacency's (twice, to sort them by source) could not fit in shared
    memory beside its ring."""
    words = B * T * (1 + S) + B * S + (B * T * S if need_dadj else 0)
    if _dense_chain_global(S * S, S):
        words += 1 + 2 * B * S * S
    return words


def _dense_chain_global(nnz, S):
    """Whether the chain keeps ``nnz`` arcs by source in global memory:
    where the two lists it sorts them from (4 nnz words) or the arcs and
    its ring do not fit in its shared memory."""
    arena = _build.MAX_SMEM // 4 - _fact_arena(S, 1, 2 * S)
    return 4 * nnz > arena or _dense_arc_words(nnz) + RING * _dense_ring_row(S) > arena


def dense_plan(adj_exp, has_lab, lengths):
    """What the dense kernels do with each sample, computed on the host
    from the same inputs (for logs and tests; the kernels plan on the
    device): its real arcs into labelled states, labelled states, largest
    in- and out-degree, the forward's rounds, the warps that run its frames,
    its route (registers, shared, global) and where its emission rows live
    (staged, ring), and the chain's group width, source rounds, warps (and
    the side warp) and route."""
    words = _build.MAX_SMEM // 4
    B, S, _ = adj_exp.shape
    nz = (adj_exp != 0).cpu()
    lab = (has_lab > 0).cpu()
    plans = []
    for b in range(B):
        members = torch.nonzero(lab[b])[:, 0].tolist()
        jslot = [0 if x else -1 for x in lab[b].tolist()]
        rows = nz[b][members]
        deg = rows.sum(1).tolist()
        nnz = int(sum(deg))
        out_deg = int(rows.sum(0).max()) if members else 0
        arena = words - _fact_arena(S, 1, _dense_fwd_vec(S))
        dense = _dense_arc_words(nnz) + RING * S > arena
        rounds, wbeg = dest_rounds([S] * len(deg) if dense else deg, jslot, members,
                                   shift_cost=DENSE_ROUND_COST)
        most = max(wbeg[w + 1] - wbeg[w] for w in range(FACT_WARPS))
        wide = max(deg, default=0) > 32 * FACT_CAP
        g = group_width(out_deg)
        chain_rounds = -(-S * g // 32)
        chain_warps = min(chain_rounds, FACT_WARPS - 1)
        plans.append(dict(
            arcs=nnz, labelled=len(members),
            max_in_degree=int(max(deg, default=0)), max_out_degree=out_deg,
            rounds=len(rounds), warps=max(1, min(len(rounds), FACT_WARPS)),
            route=("global" if dense else "registers"
                   if most <= DENSE_REG_ROUNDS and not wide else "shared"),
            rows=("staged" if (0 if dense else _dense_arc_words(nnz))
                  + max(1, int(lengths[b])) * S <= arena else "ring"),
            chain_group=g, chain_rounds=chain_rounds, chain_warps=chain_warps,
            chain_route=("global" if _dense_chain_global(nnz, S)
                         else "registers" if -(-chain_rounds // chain_warps) <= DENSE_REG_ROUNDS
                         and out_deg <= g * FACT_CAP else "shared")))
    return plans


def _fact_check(name, em_or_traj, adj, wsel, lab_oh, start, lengths):
    _build.require_cuda(name, em_or_traj, adj, wsel, lab_oh, start, lengths)
    B, T, S = em_or_traj.shape
    N = wsel.shape[2]
    _build.require(f"{name} states", em_or_traj, (B, T, S), torch.float32)
    _build.require(f"{name} adj_exp", adj, (B, S, S), torch.float32)
    _build.require(f"{name} wsel", wsel, (B, S, N), torch.float32)
    _build.require(f"{name} lab_oh", lab_oh, (B, S, N), torch.float32)
    _build.require(f"{name} start", start, (B, S), torch.float32)
    _build.require(f"{name} lengths", lengths, (B,), torch.int32)
    if T < 1 or N < 1:
        raise ValueError(f"{name} needs at least one frame and one label")
    if S >= 2**16 or min(S, N) > 2**13:
        raise ValueError(f"{name}: the kernels take S < 2^16 states and at most 2^13 "
                         f"labels in use, got S={S}, N={N}")
    return B, T, S, N


def _bwd_scratch_words(B, T, S, N, need_dadj):
    """Floats of the backward's scratch (``factored_scan_bwd``): sh
    [B, T, Lmax], rz [B, T, S], the slots [B, S], with dadj dz [B, T, S];
    and, from an even offset, 3 S^2 a sample for the chain's arcs and sums
    where a dense adjacency's could not fit in shared memory beside its
    ring."""
    L = min(S, N)
    words = B * T * (L + S) + B * S + (B * T * S if need_dadj else 0)
    if _fact_arena(S, N, 2 * S) + RING * (2 * S + L) + 3 * S * S > _build.MAX_SMEM // 4:
        words += 1 + 3 * B * S * S
    return words


def factored_scan_fwd_cuda(em_state, adj_exp, wsel, lab_oh, ws_state, start,
                           lengths):
    """Launch ``factored_scan_fwd``: em_state [B, T, S], adj_exp [B, S, S],
    wsel/lab_oh [B, S, N], ws_state/start [B, S] float32, lengths [B] int32
    -> traj [B, T, S]."""
    B, T, S, N = _fact_check("factored_scan_fwd", em_state, adj_exp, wsel, lab_oh,
                             start, lengths)
    _build.require_cuda("factored_scan_fwd", em_state, ws_state)
    _build.require("factored_scan_fwd ws_state", ws_state, (B, S), torch.float32)
    lab_idx = label_index(lab_oh)
    traj = torch.empty((B, T, S), dtype=torch.float32, device=em_state.device)
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(em_state.device):
        err = lib.factored_scan_fwd(
            em_state.data_ptr(), adj_exp.data_ptr(), wsel.data_ptr(),
            lab_idx.data_ptr(), ws_state.data_ptr(), start.data_ptr(),
            lengths.data_ptr(), traj.data_ptr(),
            B, T, S, N, _build.MAX_SMEM, _build.stream_handle(em_state),
        )
    _build.check(lib, err, "factored_scan_fwd")
    _build.LAUNCHES["factored_scan_fwd"] += 1
    return traj


def factored_scan_bwd_cuda(traj, adj_exp, wsel, lab_oh, start, lengths,
                           g_final, need_dadj=True):
    """Launch ``factored_scan_bwd`` (the statistics pass and the chain, and
    the dadj pass with ``need_dadj``): traj [B, T, S], adj_exp [B, S, S],
    wsel/lab_oh [B, S, N], start/g_final [B, S] float32, lengths [B] int32
    -> (dem [B, T, S], dadj [B, S, S] or None, dwsel [B, S, N], dws [B, S])."""
    B, T, S, N = _fact_check("factored_scan_bwd", traj, adj_exp, wsel, lab_oh,
                             start, lengths)
    _build.require_cuda("factored_scan_bwd", traj, g_final)
    _build.require("factored_scan_bwd g_final", g_final, (B, S), torch.float32)
    lab_idx = label_index(lab_oh)
    dev = traj.device
    dem = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    dadj = torch.empty_like(adj_exp) if need_dadj else None
    dwsel = torch.empty_like(wsel)
    dws = torch.empty((B, S), dtype=torch.float32, device=dev)
    scratch = torch.empty(_bwd_scratch_words(B, T, S, N, need_dadj),
                          dtype=torch.float32, device=dev)
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(dev):
        err = lib.factored_scan_bwd(
            traj.data_ptr(), adj_exp.data_ptr(), wsel.data_ptr(),
            lab_idx.data_ptr(), start.data_ptr(), lengths.data_ptr(),
            g_final.data_ptr(), dem.data_ptr(),
            dadj.data_ptr() if need_dadj else None, dwsel.data_ptr(),
            dws.data_ptr(), scratch.data_ptr(),
            B, T, S, N, _build.MAX_SMEM, _build.stream_handle(traj),
        )
    _build.check(lib, err, "factored_scan_bwd")
    _build.LAUNCHES["factored_scan_bwd"] += 1
    return dem, dadj, dwsel, dws


def chain_probe(B, threads, frames, device):
    """Launch ``factored_chain_probe``: B blocks of ``threads`` threads run
    ``frames`` frames of the factored scans' chain without arcs (a
    dependent shared-memory load, one expf and one logf, and a block
    barrier each).  Not a kernel of any path: it times one frame's floor
    for the chain bound."""
    out = torch.empty((B * threads,), dtype=torch.float32, device=device)
    lib = _build.load_library("dense_scan")
    with torch.cuda.device(device):
        err = lib.factored_chain_probe(out.data_ptr(), B, threads, frames,
                                       _build.stream_handle(out))
    _build.check(lib, err, "factored_chain_probe")
    return out


class _FactoredScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em_state, adj_exp, wsel, lab_oh, ws_state, start, lengths):
        em_state = em_state.to(torch.float32).contiguous()
        adj_exp = adj_exp.to(torch.float32).contiguous()
        wsel = wsel.to(torch.float32).contiguous()
        lab_oh = lab_oh.to(torch.float32).contiguous()
        ws_state = ws_state.to(torch.float32).contiguous()
        start = start.to(torch.float32).contiguous()
        lengths = lengths.to(device=em_state.device, dtype=torch.int32).contiguous()
        args = (em_state, adj_exp, wsel, lab_oh, ws_state, start, lengths)
        if _build.on_cuda(em_state):
            traj = factored_scan_fwd_cuda(*args)
        else:
            traj = factored_scan_fwd_plain(*args)
        ctx.save_for_backward(traj, adj_exp, wsel, lab_oh, start, lengths)
        return traj[:, -1].clone()

    @staticmethod
    def backward(ctx, g_final):
        traj, adj_exp, wsel, lab_oh, start, lengths = ctx.saved_tensors
        g_final = g_final.to(torch.float32).contiguous()
        args = (traj, adj_exp, wsel, lab_oh, start, lengths, g_final,
                ctx.needs_input_grad[1])
        if _build.on_cuda(traj):
            dem, dadj, dwsel, dws = factored_scan_bwd_cuda(*args)
        else:
            dem, dadj, dwsel, dws = factored_scan_bwd_plain(*args)
        return dem, dadj, dwsel, None, dws, None, None


def factored_scan(em_state, adj_exp, wsel, lab_oh, ws_state, start, lengths):
    """Final alpha [B, S] of the transition-factored recursion.

    Args:
      em_state: [B, T, S] per-state emissions.
      adj_exp: [B, S, S] — adj_exp[b, u, s] = sum over arcs s -> u of e^w.
      wsel: [B, S, N] — wsel[b, s, l] = W[l_s, l], the bigram weight of
        entering label l from state s.
      lab_oh: [B, S, N] one-hot of each state's in-label (zero rows for
        states without one).
      ws_state: [B, S] start weight of each state's label (frame 0).
      start: [B, S] 0-or-NEG start potentials.
      lengths: [B] int input lengths (frame 0 is applied even at 0).
    Differentiable in ``em_state``, ``adj_exp``, ``wsel`` and ``ws_state``.
    """
    return _FactoredScan.apply(em_state, adj_exp, wsel, lab_oh, ws_state,
                               start, lengths)
