"""Dense-adjacency alignment-lattice scoring (PyTorch).

Counterpart of ``gtn_applications_tpu/ops/factored.py``:

  * ``alignment_lattice_score``, ``factored_lattice_score``,
    ``dense_ngram_norm`` and ``ngram_rows``: the forward score of
    per-sample alignment lattices in which every state has a unique
    in-label, without a transition factor (one ``[B, S] x [B, S, S]``
    exp-matvec per frame) or under a full bigram transition model, and the
    normaliser of that model.  The recursions run through ``dense_scan``
    and ``factored_scan`` (``ops/dense_scan_pallas.py``): their CUDA
    kernels on CUDA tensors, their plain versions on CPU tensors.  The JAX
    package leaves those whole-scan kernels opt-in (``GTN_DENSE_SCAN``)
    because the TPU's per-grid-step overhead lost to XLA's loop, and trains
    the bigram scorer through an analytic-VJP fold (``factored_vjp``)
    instead; on the H100 one block per sample with the time loop inside has
    no such overhead, so the port always takes the kernels (with the JAX
    floor of 1e-37, ``dense_scan_pallas._FLOOR``), whose autograd Functions
    carry their own backwards: ``factored_vjp`` has no counterpart here.
  * the backoff factorings: a loaded (pruned, backoff) transition graph
    scored against the alignment lattices without composing it into them,
    over a dense context axis.  ``backoff_factored_score`` with
    ``backoff_dense_norm`` ("dense": per-label ``[N, S_c, S_c]``
    exp-matrices) and, for graphs whose label decides an advance arc's
    destination (every n-gram automaton ``scripts/build_transitions.py``
    emits), ``backoff_dst_factored_score`` (its staged form, the
    full-range oracle) or ``backoff_dst_exp_score`` (the exp-linear tier)
    with ``backoff_dst_norm`` ("dst": ``[S_c, N]`` matrices, the regime of
    1k-wordpiece LMs), the epsilon (backoff) closure dense or low-rank
    (``eps_chain_struct``, ``eps_lowrank_build``); and
    ``backoff_dst_viterbi``, the tropical decode through such a graph.
    ``GTN_FACTORED_VJP`` picks the dst tier as in JAX: ``auto`` the
    exp-linear tier, ``off`` the staged form.  These are loops of PyTorch
    products and elementwise ops over the frames, as JAX's are ``lax.scan``s
    of XLA ones (no Pallas kernel): on the H100, 140-260 launches a frame
    forward and backward for the dst tiers and about 440 for the dense
    variant with a depth-3 closure (``chip_smoke.py`` prints the counts).
    JAX's one-hot contractions, there because gathers are slow on the TPU,
    are exact gathers here (the same values), and the decode's first-hit
    selections ``torch.max``'s first maximum (the same tie rule: the lowest
    context and the lowest label win).

The products must run in full fp32 (JAX measured 0.28 nats of loss error at
T=250 from reduced-precision products accumulating over the frames):
``_mm`` switches TF32 off for its forward and its backward, whatever the
global flag says, and restores the flag after.
"""

import contextlib
import os

import numpy as np
import torch

from .dense_scan_pallas import _FLOOR, _TINY, dense_scan, factored_scan
from .semiring import DEAD, NEG, logaddexp, logsumexp

# the destination-factored backoff score: "auto" (JAX's default) through
# the exp-linear tier, "off" through the staged form (the full-range oracle)
_VJP_IMPL = os.environ.get("GTN_FACTORED_VJP", "auto")


def _use_vjp():
    return _VJP_IMPL not in ("off", "0")


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for CUDA matmuls inside, the global flag restored after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class _MatMulF32(torch.autograd.Function):
    """``a @ b`` with TF32 off in the forward and in the backward (which
    autograd runs after the scorer has returned)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _no_tf32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _no_tf32():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.mT).sum_to_size(a.shape)
            if ctx.needs_input_grad[1]:
                if b.dim() == 2:  # a shared right operand: one product
                    gb = a.reshape(-1, a.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
                else:
                    gb = torch.matmul(a.mT, g).sum_to_size(b.shape)
        return ga, gb


def _mm(a, b):
    return _MatMulF32.apply(a, b)


def alignment_lattice_score(em, adj_exp, lab_oh, start, accept,
                            input_lengths=None):
    """Forward score [B] of alignment lattices with no transition factor.

    Args:
      em: [B, T, N] emissions (N = alignment channels incl. blank).
      adj_exp: [B, S, S] — adj_exp[b, s', s] = sum over arcs s -> s' of e^w
        (parallel arcs lse-merge exactly).
      lab_oh: [B, S, N] — one-hot of each state's unique in-label.
      start, accept: [B, S] potentials (0 / NEG).
      input_lengths: [B] int or None (every frame live).
    """
    B, T, _ = em.shape
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    input_lengths = input_lengths.to(em.device)

    em_state = torch.einsum("btn,bsn->bts", em, lab_oh)      # [B, T, S]
    has_lab = torch.sum(lab_oh, dim=-1) > 0.0                 # [B, S]
    alpha = dense_scan(em_state, adj_exp, start, has_lab.to(em.dtype),
                       input_lengths)
    score = logsumexp(alpha + accept, dim=1)
    # zero-frame samples: the empty path (start and accept), if any
    base0 = logsumexp(start + accept, dim=1)
    score0 = torch.where(base0 > DEAD, base0, NEG)
    return torch.where(input_lengths > 0, score, score0)


def factored_lattice_score(em, adj_exp, lab_oh, start, accept, ws, W, we,
                           input_lengths=None, we0=0.0):
    """Forward score [B] of alignment lattices under a bigram transition
    factor.

    Args:
      em: [B, T, N] emissions (N = alignment channels incl. blank).
      adj_exp: [B, S, S] — adj_exp[b, s', s] = sum over arcs s -> s' of e^w.
      lab_oh: [B, S, N] one-hot of each state's unique in-label (zero rows
        for padding / pure-start states).
      start, accept: [B, S] potentials (0 / NEG).
      ws, W, we: [N], [N, N] (W[l_prev, l_cur]), [N] transition rows.
      input_lengths: [B] int or None (every frame live).
      we0: end weight of the empty path (the n-gram root's final epsilon);
        only reachable when a sample's input length is 0.
    """
    B, T, N = em.shape
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    input_lengths = input_lengths.to(em.device)

    # per-state emission / transition rows by exact one-hot contraction
    em_state = torch.einsum("btn,bsn->bts", em, lab_oh)      # [B, T, S]
    ws_state = torch.einsum("n,bsn->bs", ws, lab_oh)
    we_state = torch.einsum("n,bsn->bs", we, lab_oh)
    wsel = torch.einsum("bsn,nl->bsl", lab_oh, W)             # [B, S, N]
    alpha = factored_scan(em_state, adj_exp, wsel, lab_oh, ws_state, start,
                          input_lengths)
    score = logsumexp(alpha + accept + we_state, dim=1)
    # zero-frame samples: only paths that consume nothing (start and accept
    # in the alignment lattice, the root's final epsilon in the n-gram);
    # we0 joins only when the empty path exists, else its grad would leak
    base0 = logsumexp(start + accept, dim=1)
    score0 = torch.where(base0 > DEAD, base0 + we0, NEG)
    return torch.where(input_lengths > 0, score, score0)


def dense_ngram_norm(em, ws, W, we, input_lengths=None, we0=0.0):
    """Normaliser [B]: forward score of the emissions through the full
    n-gram transition lattice alone (dense over label contexts).

    alpha_1[l] = ws[l] + em[0, l];  alpha_t[l'] = em[t, l'] +
    lse_l(alpha[l] + W[l, l']);  score = lse_l(alpha_T[l] + we[l]).
    Zero-frame samples score the empty path, ``we0``.  As in the JAX
    package it is a loop of one shared ``[B, N] @ [N, N]`` product a frame
    (about 12 launches a frame forward, autograd's backward about twice
    that), not a kernel.
    """
    B, T, N = em.shape
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    lens = input_lengths.to(em.device).view(B, 1)

    alpha = ws[None, :] + em[:, 0]
    mt = torch.amax(W, dim=0).detach()                        # [N]
    exp_W = torch.exp(W - mt[None, :])
    for t in range(1, T):
        ma = torch.amax(alpha, dim=1, keepdim=True).detach()
        z = torch.exp(alpha - ma) @ exp_W
        new = em[:, t] + ma + mt[None, :] + torch.log(torch.clamp(z, min=_FLOOR))
        alpha = torch.where(t < lens, new, alpha)
    final = alpha + we[None, :]
    return torch.where(lens[:, 0] > 0, logsumexp(final, dim=1),
                       torch.as_tensor(we0, dtype=em.dtype, device=em.device))


def ngram_rows(params, ngram, num_channels):
    """Split the flat learnable arc-weight vector of
    ``make_transitions_graph(ngram, num_channels)`` into (ws, W, we, we0)
    following its arc creation order (criterions/transducer.py): root arcs
    [0, N), full-order arcs [N, N + N^2) context-major, then one epsilon
    arc per state (root first) for ngram 2.  ``we0`` is the root's
    final-epsilon weight (the empty path's end weight)."""
    N = num_channels
    p = params
    if ngram == 1:
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        return p[:N], p[None, :N].expand(N, N), zero.expand(N), zero
    if ngram == 2:
        return (p[:N], p[N:N + N * N].reshape(N, N),
                p[N + N * N + 1:N + N * N + 1 + N], p[N + N * N])
    raise ValueError(f"factored path supports ngram in (1, 2), got {ngram}")


# ---------------------------------------------------------------------------
# The backoff factorings (a loaded transition graph over S_c contexts)
# ---------------------------------------------------------------------------


def _lengths(input_lengths, B, T, device):
    if input_lengths is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return torch.as_tensor(input_lengths).to(device)


def _labels(lab_oh):
    """(each state's in-label [B, S] int64, 0 for a zero row; has_lab [B, S])."""
    return torch.argmax(lab_oh, dim=-1), torch.sum(lab_oh, dim=-1) > 0.0


def _by_label(rows, idx, has_lab):
    """``rows[idx]`` [B, S, ...]: each state's row of ``rows`` [N, ...] by its
    in-label, 0 for a state without one (JAX's one-hot contraction)."""
    picked = rows[idx]
    mask = has_lab.reshape(has_lab.shape + (1,) * (picked.dim() - 2))
    return torch.where(mask, picked, 0.0)


def _em_state(em, idx, has_lab):
    """[B, T, S] emission of each state's in-label, 0 for a state without one."""
    B, T, _ = em.shape
    picked = em.gather(2, idx[:, None, :].expand(B, T, idx.shape[1]))
    return torch.where(has_lab[:, None, :], picked, 0.0)


def _shift(x, dim):
    """The gradient-free max of ``x`` along ``dim`` (kept), at least NEG."""
    return torch.clamp(torch.amax(x, dim=dim, keepdim=True), min=NEG).detach()


def _log_or_neg(z, base):
    """base + log z for a live (normal, positive) sum z, else NEG: a sum
    below the least normal float32 is dead, as on JAX's devices."""
    return torch.where(z >= _TINY, base + torch.log(torch.clamp(z, min=_FLOOR)), NEG)


def _ctx_closure(x, E_exp, e_shift, depth):
    """Bounded epsilon (backoff) closure along the trailing context axis of
    ``x [..., S_c]`` (log space); ``E_exp[c, c'] = sum over epsilon arcs
    c -> c' of e^(w - e_shift)``.  The acc/cur recursion of the sparse
    scans' epsilon closure."""
    acc = cur = x
    for _ in range(depth):
        m = _shift(cur, -1)
        cur = _log_or_neg(_mm(torch.exp(cur - m), E_exp), m + e_shift)
        acc = logaddexp(acc, cur)
    return acc


def eps_chain_struct(eps_src, eps_dst, num_states, eps_depth, max_paths=32):
    """Host-static low-rank structure of a backoff automaton's epsilon
    closure (numpy; the JAX package's own, copied).

    In the n-gram automata ``scripts/build_transitions.py`` emits, epsilon
    paths from any context land in a tiny set of states: the backoff
    (lower-order context) chain and the merged ``</s>`` accept state.  ``Mc - I`` (the
    off-identity part of the closure matrix ``sum_k E^k``) is then rank K
    with K = |union of landing states|, and the closure ``Z @ Mc``
    collapses to ``Z + (Z @ U) @ C`` with U [S_c, K], C [K, S_c].

    Enumerates every epsilon path of length 1..eps_depth from each state.
    Returns None (callers keep the dense closure) if there are no epsilon
    arcs, some state has more than ``max_paths`` paths, or 2K > num_states
    (no win).  Otherwise (path_arcs [S, P, depth] int32, the arc ids of
    each path, -1 padding (an unused path slot has path_arcs[s, p, 0] ==
    -1); path_col_oh [S, P, K] f32, one-hot of each path's landing column;
    col_onehot [K, S] f32).  ``eps_lowrank_build`` folds the learnable arc
    weights into U."""
    eps_src = np.asarray(eps_src)
    eps_dst = np.asarray(eps_dst)
    if len(eps_src) == 0 or eps_depth == 0:
        return None
    arcs_of = [[] for _ in range(num_states)]
    for i, s in enumerate(eps_src):
        arcs_of[s].append(i)
    paths = []  # per state: list of (arc_id_tuple, end_state)
    for s in range(num_states):
        got = []
        frontier = [((), s)]
        for _ in range(eps_depth):
            nxt = []
            for chain, at in frontier:
                for a in arcs_of[at]:
                    p = (chain + (a,), int(eps_dst[a]))
                    got.append(p)
                    nxt.append(p)
            frontier = nxt
            if len(got) > max_paths:
                return None
        paths.append(got)
    P = max((len(g) for g in paths), default=0)
    if P == 0:
        return None
    cols = np.unique([e for g in paths for _, e in g])
    K = len(cols)
    if 2 * K > num_states:
        return None
    col_of = np.full((num_states,), -1, np.int64)
    col_of[cols] = np.arange(K)
    path_arcs = np.full((num_states, P, eps_depth), -1, np.int32)
    path_col_oh = np.zeros((num_states, P, K), np.float32)
    for s, g in enumerate(paths):
        for p, (chain, end) in enumerate(g):
            path_arcs[s, p, : len(chain)] = chain
            path_col_oh[s, p, col_of[end]] = 1.0
    col_onehot = np.zeros((K, num_states), np.float32)
    col_onehot[np.arange(K), cols] = 1.0
    return path_arcs, path_col_oh, col_onehot


def eps_lowrank_build(ew_eff, struct):
    """Fold the effective epsilon arc weights ``ew_eff [E]`` (static weight
    plus the learnable one, no shift) into the low-rank closure factors of
    ``struct`` (``eps_chain_struct``'s arrays as tensors on ``ew_eff``'s
    device).  Returns (U [S, K], C [K, S]): closure(z) = z + (z @ U) @ C,
    exactly ``z @ (I + sum_k E^k)`` with E[c, d] = e^ew_eff(arc c -> d):
    each path's weight is the exp of its arcs' sum."""
    path_arcs, path_col_oh, col_onehot = struct
    w = torch.where(path_arcs >= 0, ew_eff[path_arcs.clamp(min=0).long()], 0.0)
    pathw = torch.where(path_arcs[:, :, 0] >= 0, torch.exp(torch.sum(w, dim=2)), 0.0)
    return torch.sum(pathw[:, :, None] * path_col_oh, dim=1), col_onehot


def _lowrank_close_exp(z2d, eps_lowrank):
    """closure(z) = z + (z @ U) @ C on a [rows, S_c] exp-domain matrix."""
    U, C = eps_lowrank
    return z2d + _mm(_mm(z2d, U), C)


def _empty_path_score(a_start, a_accept, ctx0, ctx_accept):
    """Zero-frame samples: the separable empty-path score.  Its context half
    joins only when the alignment admits the empty path, else its gradient
    (through learned epsilon and accept weights) would leak."""
    base0 = logsumexp(a_start + a_accept, dim=1)
    return torch.where(base0 > DEAD, base0 + logsumexp(ctx0 + ctx_accept, dim=0), NEG)


def _final_score(alpha, a_accept, ctx_accept, score0, lens):
    B = alpha.shape[0]
    final = alpha + a_accept[:, :, None] + ctx_accept[None, None, :]
    score = logsumexp(final.reshape(B, -1), dim=1)
    return torch.where(lens > 0, score, score0)


def backoff_factored_score(em, adj_exp, lab_oh, a_start, a_accept, ctx_start,
                           ctx_accept, T_exp, t_shift, E_exp, e_shift, eps_depth,
                           input_lengths=None):
    """Forward score [B] of alignment lattices composed with a loaded
    (pruned, backoff) transition graph over S_c contexts, without composing.

    The product state is (alignment state, context); since every alignment
    state has a unique in-label, a frame factorizes into
      U[b, a, c] = lse over alignment predecessors s of alpha[b, s, c],
      V[b, a, d] = lse over contexts c of U + w_real[c, d, L(a)],
      alpha'     = em[t, L(a)] + V, then the backoff closure along c.
    JAX forms the contraction for every label, [B, S_a, N, S_c], and picks
    L(a) by a one-hot sum; here the contraction for every label is one
    ``[B S_a, S_c] @ [S_c, N S_c]`` product whose pick by L(a) is a gather
    (the same sum; the [B, S_a, N, S_c] product is transient, not kept for
    the backward).

    Args:
      em: [B, T, N] emissions.
      adj_exp, lab_oh, a_start, a_accept: the alignment side as in
        ``factored_lattice_score``.
      ctx_start, ctx_accept: [S_c] context potentials (0 / NEG).
      T_exp: [N, S_c, S_c], T_exp[l, c, d] = sum over real arcs c -> d
        labelled l of e^(w - t_shift); t_shift a scalar.
      E_exp: [S_c, S_c] epsilon matrix (shifted by e_shift).
      eps_depth: the transition graph's closure bound.
    """
    B, T, N = em.shape
    S_a, S_c = adj_exp.shape[1], ctx_start.shape[0]
    lens = _lengths(input_lengths, B, T, em.device)
    idx, has_lab = _labels(lab_oh)
    em_state = _em_state(em, idx, has_lab)
    ctx0 = _ctx_closure(ctx_start[None], E_exp, e_shift, eps_depth)[0]
    alpha = a_start[:, :, None] + ctx0[None, None, :]             # [B, S_a, S_c]
    T_cat = T_exp.permute(1, 0, 2).reshape(S_c, N * S_c)
    pick = idx.reshape(B * S_a, 1, 1).expand(B * S_a, 1, S_c)
    for t in range(T):
        sh1 = _shift(alpha, 1)
        U = _log_or_neg(_mm(adj_exp, torch.exp(alpha - sh1)), sh1)
        sh2 = _shift(U, 2)
        Z = _mm(torch.exp(U - sh2).reshape(B * S_a, S_c), T_cat)
        Y = Z.view(B * S_a, N, S_c).gather(1, pick).view(B, S_a, S_c)
        new = em_state[:, t, :, None] + _log_or_neg(Y, sh2 + t_shift)
        new = torch.where(has_lab[:, :, None], new, NEG)
        new = _ctx_closure(new, E_exp, e_shift, eps_depth)
        alpha = torch.where((t < lens)[:, None, None], new, alpha)
    return _final_score(alpha, a_accept, ctx_accept,
                        _empty_path_score(a_start, a_accept, ctx0, ctx_accept), lens)


def backoff_dst_factored_score(em, adj_exp, lab_oh, a_start, a_accept, ctx_start,
                               ctx_accept, W_adv_exp, D_exp_t, P_dst, t_shift, E_exp,
                               e_shift, eps_depth, input_lengths=None, eps_lowrank=None):
    """``backoff_factored_score`` for transition graphs whose non-self arcs
    have a label-determined destination (label l advances to l's context,
    blank and self-loop arcs stay).  The [N, S_c, S_c] tensor collapses to
    [S_c, N]-sized matrices:

        Y[b, a, d] = (eU @ W_adv_exp)[b, a, L(a)] [d == dst_L(a)]
                     + eU[b, a, d] D_exp[d, L(a)]

    Under ``GTN_FACTORED_VJP`` other than off (JAX's default) it returns
    ``backoff_dst_exp_score``; off keeps this staged form, the full-range
    oracle.

    Args (beyond ``backoff_factored_score``'s):
      W_adv_exp: [S_c, N], sum over non-self arcs c -> dst_l labelled l of
        e^(w - t_shift).
      D_exp_t: [N, S_c], the transposed self-loop matrix D_exp[c, l].
      P_dst: [N, S_c] one-hot of each label's advance destination (zero
        rows for labels with no non-self arc).
      eps_lowrank: the exp tier's low-rank closure (U, C) or None.
    """
    if _use_vjp():
        return backoff_dst_exp_score(
            em, adj_exp, lab_oh, a_start, a_accept, ctx_start, ctx_accept, W_adv_exp,
            D_exp_t, P_dst, t_shift, E_exp, e_shift, eps_depth, input_lengths,
            eps_lowrank=eps_lowrank)
    B, T, N = em.shape
    lens = _lengths(input_lengths, B, T, em.device)
    idx, has_lab = _labels(lab_oh)
    em_state = _em_state(em, idx, has_lab)
    Pd = _by_label(P_dst, idx, has_lab)                            # [B, S_a, S_c]
    Dl = _by_label(D_exp_t, idx, has_lab)
    ctx0 = _ctx_closure(ctx_start[None], E_exp, e_shift, eps_depth)[0]
    alpha = a_start[:, :, None] + ctx0[None, None, :]
    for t in range(T):
        sh1 = _shift(alpha, 1)
        U = _log_or_neg(_mm(adj_exp, torch.exp(alpha - sh1)), sh1)
        sh2 = _shift(U, 2)
        eU = torch.exp(U - sh2)
        adv = _mm(eU, W_adv_exp).gather(2, idx[:, :, None])      # [B, S_a, 1]
        Y = adv * Pd + eU * Dl
        new = em_state[:, t, :, None] + _log_or_neg(Y, sh2 + t_shift)
        new = torch.where(has_lab[:, :, None], new, NEG)
        new = _ctx_closure(new, E_exp, e_shift, eps_depth)
        alpha = torch.where((t < lens)[:, None, None], new, alpha)
    return _final_score(alpha, a_accept, ctx_accept,
                        _empty_path_score(a_start, a_accept, ctx0, ctx_accept), lens)


def backoff_dst_exp_score(em, adj_exp, lab_oh, a_start, a_accept, ctx_start,
                          ctx_accept, W_adv_exp, D_exp_t, P_dst, t_shift, E_exp,
                          e_shift, eps_depth, input_lengths=None, eps_lowrank=None):
    """Exp-linear form of ``backoff_dst_factored_score``.

    The frame is linear in exp(alpha): with Eu = adj_exp @ exp(alpha), the
    advance term is a per-state dot with W_adv_exp's label column, the
    self-loop term a product with D's label row, and the backoff closure a
    fixed matrix Mc = sum_k (E_exp e^e_shift)^k (or its low-rank form
    ``eps_lowrank``).  The label selections fold into three per-sample
    [S_a, S_c] matrices once; a frame is one batched [S_a, S_a] @ [S_a, S_c]
    product, a multiply-reduce and one closure product.

    Envelope: one shift per frame (the max over the whole [S_a, S_c]
    carry), so terms more than ~88 nats below it flush; the staged form
    (``GTN_FACTORED_VJP=off``) shifts per axis."""
    B, T, N = em.shape
    S_a, S_c = adj_exp.shape[1], ctx_start.shape[0]
    lens = _lengths(input_lengths, B, T, em.device)
    idx, has_lab = _labels(lab_oh)
    em_state = _em_state(em, idx, has_lab)
    WlT = _by_label(W_adv_exp.T, idx, has_lab)                     # W_adv[c, L(a)]
    Dl = _by_label(D_exp_t, idx, has_lab)                          # D[c, L(a)]
    Pd = _by_label(P_dst, idx, has_lab)                            # dst one-hot
    if eps_lowrank is not None:
        def close(z):
            return _lowrank_close_exp(z, eps_lowrank)
    else:
        Mc = torch.eye(S_c, dtype=em.dtype, device=em.device)
        cur = Mc
        E_sh = E_exp * torch.exp(e_shift)
        for _ in range(eps_depth):
            cur = _mm(cur, E_sh)
            Mc = Mc + cur

        def close(z):
            return _mm(z, Mc)

    z0 = close((torch.exp(torch.clamp(ctx_start, max=0.0))
                * (ctx_start > NEG / 2))[None])[0]
    ctx0 = _log_or_neg(z0, 0.0)
    alpha = a_start[:, :, None] + ctx0[None, None, :]
    for t in range(T):
        sh = _shift(alpha.reshape(B, -1), 1)[:, :, None]
        Eu = _mm(adj_exp, torch.exp(alpha - sh))
        advv = torch.sum(Eu * WlT, dim=2)                          # [B, S_a]
        em_t = em_state[:, t]
        me = _shift(em_t, 1)
        Z = (advv[:, :, None] * Pd + Eu * Dl) * torch.exp(em_t - me)[:, :, None]
        Zc = close(Z.reshape(B * S_a, S_c)).reshape(B, S_a, S_c)
        new = torch.where(has_lab[:, :, None],
                          _log_or_neg(Zc, sh + me[:, :, None] + t_shift), NEG)
        alpha = torch.where((t < lens)[:, None, None], new, alpha)
    return _final_score(alpha, a_accept, ctx_accept,
                        _empty_path_score(a_start, a_accept, ctx0, ctx_accept), lens)


def backoff_dense_norm(em, ctx_start, ctx_accept, T_exp, t_shift, E_exp, e_shift,
                       eps_depth, input_lengths=None):
    """Normaliser [B] of ``backoff_factored_score``: the emissions through
    the transition graph alone as a dense [B, S_c] recursion,

        new[b, d] = lse over c, l of alpha[b, c] + w(c, l, d) + em[t, l],

    closed after the start and after every frame."""
    B, T, N = em.shape
    S_c = ctx_start.shape[0]
    lens = _lengths(input_lengths, B, T, em.device)
    alpha = _ctx_closure(ctx_start[None].expand(B, S_c), E_exp, e_shift, eps_depth)
    T_cat = T_exp.permute(1, 0, 2).reshape(S_c, N * S_c)
    for t in range(T):
        em_t = em[:, t]
        sh, me = _shift(alpha, 1), _shift(em_t, 1)
        Z = _mm(torch.exp(alpha - sh), T_cat).view(B, N, S_c)
        z = torch.sum(Z * torch.exp(em_t - me)[:, :, None], dim=1)
        new = _ctx_closure(_log_or_neg(z, sh + t_shift + me), E_exp, e_shift, eps_depth)
        alpha = torch.where((t < lens)[:, None], new, alpha)
    return logsumexp(alpha + ctx_accept[None, :], dim=1)


def backoff_dst_norm(em, ctx_start, ctx_accept, W_adv_exp, D_exp_t, P_dst, t_shift,
                     E_exp, e_shift, eps_depth, input_lengths=None, eps_lowrank=None):
    """Normaliser [B] of ``backoff_dst_factored_score``: the emissions
    through the transition graph alone as a dense [B, S_c] recursion,

        adv[b, l] = lse over c of alpha[b, c] + W_adv[c, l],
        new[b, d] = lse(lse over l with dst_l = d of adv[b, l] + em[t, l],
                        alpha[b, d] + lse over l of D[d, l] + em[t, l]),

    its epsilon closures in the exp domain (dense or ``eps_lowrank``),
    after the start and after every frame.  JAX folds the start's closure
    into frame 0 (a TPU compiler workaround); it is taken before the loop
    here, which is the same for every sample, zero-length ones included."""
    B, T, N = em.shape
    S_c = ctx_start.shape[0]
    lens = _lengths(input_lengths, B, T, em.device)
    if eps_lowrank is not None:
        def close(z):
            return _lowrank_close_exp(z, eps_lowrank)
    else:
        # z (I + E + ... + E^depth), E = E_exp e^e_shift: exact, since E is
        # nilpotent past the backoff chain's depth
        E_sh = E_exp * torch.exp(e_shift)

        def close(z):
            zc = z
            for _ in range(eps_depth):
                zc = _mm(zc, E_sh)
                z = z + zc
            return z
    alpha = ctx_start[None].expand(B, S_c)
    sh0 = _shift(alpha, 1)
    alpha = _log_or_neg(close(torch.exp(alpha - sh0)), sh0)
    for t in range(T):
        em_t = em[:, t]
        sh, me = _shift(alpha, 1), _shift(em_t, 1)
        eA, e_em = torch.exp(alpha - sh), torch.exp(em_t - me)
        # every term carries the common factor e^(x - sh - t_shift - me)
        z = close(_mm(_mm(eA, W_adv_exp) * e_em, P_dst) + eA * _mm(e_em, D_exp_t))
        new = _log_or_neg(z, sh + t_shift + me)
        alpha = torch.where((t < lens)[:, None], new, alpha)
    return logsumexp(alpha + ctx_accept[None, :], dim=1)


def _trop_closure(alpha, org, E_log, depth):
    """Tropical epsilon closure with origins: ``alpha [B, S_c]`` scores,
    ``org [B, S_c]`` the state each score was carried from before any
    epsilon hop.  Returns the best over at most ``depth`` hops and its
    origin (the lowest source context on an exact tie)."""
    best, best_org = alpha, org
    cur, cur_org = alpha, org
    for _ in range(depth):
        nxt, arg = torch.max(cur[:, :, None] + E_log[None], dim=1)
        nxt_org = cur_org.gather(1, arg)
        take = nxt > best
        best_org = torch.where(take, nxt_org, best_org)
        best = torch.maximum(best, nxt)
        cur, cur_org = nxt, nxt_org
    return best, best_org


@torch.no_grad()
def backoff_dst_viterbi(em, ctx_start, ctx_accept, W_adv_log, D_log, dst_oh, E_log,
                        eps_depth, input_lengths=None):
    """Tropical decode through a destination-factored backoff transition
    graph without its epsilon-removed composed table (~S_c N arcs at
    wordpiece scale).  Per frame, for each destination context d:

      advance: max over labels l with dst(l) = d of
               max over c of (alpha_eps[c] + W_adv_log[c, l]) + em[t, l]
      stay:    alpha_eps[d] + max over l of (D_log[d, l] + em[t, l])

    with the epsilon closure folded into the frame and its origins kept, so
    that the backpointer jumps over epsilon hops.  Ties: the lowest context
    and the lowest label win on an exact maximum; the advance wins over the
    stay on a tie.

    Args:
      em: [B, T, N] emissions.
      ctx_start, ctx_accept: [S_c] potentials (0 / NEG).
      W_adv_log: [S_c, N], the best non-self arc c -> dst_l labelled l;
        NEG where there is none.
      D_log: [S_c, N] self-loop weights; NEG where absent.
      dst_oh: [N, S_c] one-hot destination of each label (zero rows for
        labels with no advance arc).
      E_log: [S_c, S_c] epsilon weights; NEG where absent.
      eps_depth: the closure bound.
    Returns (labels [B, T] int32, -1 beyond input_length and on infeasible
    samples; scores [B]).
    """
    B, T, N = em.shape
    S_c = ctx_start.shape[0]
    dev = em.device
    lens = _lengths(input_lengths, B, T, dev)
    iota = torch.arange(S_c, device=dev).expand(B, S_c)
    has_dst = torch.sum(dst_oh, dim=1) > 0.0
    dst_idx = torch.argmax(dst_oh, dim=1).expand(B, N)   # 0 for no advance arc
    lab_ids = torch.arange(N, device=dev).expand(B, N)
    alpha = ctx_start[None].expand(B, S_c)
    labs, prevs = [], []
    for t in range(T):
        em_t = em[:, t]
        a_eps, org = _trop_closure(alpha, iota, E_log, eps_depth)
        # advance: the best source context of each label, then each
        # destination's best label (the lowest on a tie)
        adv, arg = torch.max(a_eps[:, :, None] + W_adv_log[None], dim=1)
        adv_org = org.gather(1, arg)
        s_lab = adv + em_t
        cand1 = torch.full((B, S_c), NEG, dtype=em.dtype, device=dev).scatter_reduce(
            1, dst_idx, s_lab, "amax")
        win = has_dst[None] & (s_lab >= cand1.gather(1, dst_idx))
        l1 = torch.full((B, S_c), N, device=dev).scatter_reduce(
            1, dst_idx, torch.where(win, lab_ids, N), "amin")
        p1 = torch.where(l1 < N, adv_org.gather(1, l1.clamp(max=N - 1)), 0)
        # stay: the best self-loop label at d
        stay, l2 = torch.max(D_log[None] + em_t[:, None, :], dim=2)
        cand2 = a_eps + stay
        take1 = cand1 >= cand2
        new = torch.maximum(cand1, cand2)
        dead = new <= NEG / 2
        live = (t < lens)[:, None]
        lab = torch.where(dead, -1, torch.where(take1, l1, l2))
        prev = torch.where(dead, iota, torch.where(take1, p1, org))
        alpha = torch.where(live, torch.clamp(new, min=NEG), alpha)
        labs.append(torch.where(live, lab, -1))
        prevs.append(torch.where(live, prev, iota))
    a_fin, org_fin = _trop_closure(alpha, iota, E_log, eps_depth)
    score, end = torch.max(a_fin + ctx_accept[None], dim=1)
    # the walk starts at the pre-closure origin of the best final state
    state = org_fin.gather(1, end[:, None])
    labels = [None] * T
    for t in reversed(range(T)):
        labels[t] = labs[t].gather(1, state)
        state = prevs[t].gather(1, state)
    labels = (torch.cat(labels, dim=1) if T
              else torch.zeros((B, 0), dtype=torch.int64, device=dev))
    # infeasible samples decode to the empty path
    labels = torch.where((score > NEG / 2)[:, None], labels, -1)
    return labels.to(torch.int32), score
