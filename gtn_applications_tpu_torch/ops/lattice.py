"""Batched lattice dynamic programs (PyTorch): the CTC and ASG halves.

Counterpart of the CTC and ASG halves of ``gtn_applications_tpu/ops/lattice.py``.  The
criterion graph is a chain with self-loops and bounded skips, so the
composition with the emissions collapses to gathering emission channels
into the 2L+1 lattice states; the score is a fixed-shape recursion over
``[B, S]`` state tensors.

``impl="auto"`` runs the kernel ``Function`` of ``ops/lattice_pallas.py``:
its CUDA kernels on CUDA tensors (they read ``log_probs`` by label, so no
gather runs), its plain versions on CPU tensors; past 4,096 frames it
takes the chunked form, as JAX's does.  ``impl="chunked"`` is that
Function run a chunk of frames at a time (``ctc_score_chunked``: the
kernels' chunk mode, the boundary alphas alone kept for the backward).
``impl="scan"`` is a plain-torch copy of the JAX ``lax.scan`` path (a
second oracle).  ``impl="assoc"`` is JAX's associative form over band
operators (``ctc_forward_score_assoc``): plain torch as JAX's is jnp and
lax, but for its emission gather, which runs the gather kernels as JAX's
runs its Pallas gather on a TPU.  ``impl="pallas"`` raises: the port's
kernels run under "auto".

ASG: the free energy is a max-shifted exp-matmul scan against the dense
transition matrix (plain ``torch.matmul``, as JAX leaves it to XLA), the
force-aligned score a banded recursion over emissions gathered by the
gather kernel, and the Viterbi decode a max/argmax scan whose backpointers
the dense backtrace kernel walks (``ops/viterbi_scan_pallas.py``).
"""

import math

import torch
from torch.utils.checkpoint import checkpoint

from .semiring import NEG, gather_channels, logaddexp, logsumexp, logsumexp_stack

# Beyond this many frames "auto" routes to the chunked form, as JAX's does:
# the whole-T Function keeps the [B, T, S] alpha trajectory for its backward,
# and its float32 alpha and beta of |score| itself lose the gradient's
# precision as T grows (the chunked form's stay within a chunk's growth).
_MAX_WHOLE_T = 4096
# JAX's default chunk of ctc_forward_score_chunked
_CHUNK = 128


def ctc_state_tables(targets, blank):
    """Per-state label / skip tables for the 2L+1-state CTC lattice.

    State s has label blank for even s and ``targets[(s-1)//2]`` for odd s;
    a skip s-2 -> s is allowed for odd s >= 3 when the two neighbouring
    labels differ.  Returns (labels [B, S] int64, skip_ok [B, S] bool).
    """
    S = 2 * targets.shape[1] + 1
    targets = targets.long()
    s = torch.arange(S, device=targets.device)
    tgt_idx = torch.clamp(torch.div(s - 1, 2, rounding_mode="floor"), min=0)
    is_label = (s % 2) == 1
    cur = targets[:, tgt_idx]
    labels = torch.where(is_label[None, :], cur, blank)
    prev_tgt = targets[:, torch.clamp(tgt_idx - 1, min=0)]
    skip_ok = is_label[None, :] & (s >= 3)[None, :] & (cur != prev_tgt)
    return labels, skip_ok


def ctc_start_accept(target_lengths, S):
    """0-or-NEG start and accept potentials [B, S]: start in states 0 and 1
    (1 only for a non-empty target), accept in 2*len and 2*len - 1."""
    s_idx = torch.arange(S, device=target_lengths.device)[None, :]
    tl = target_lengths.long()[:, None]
    start = torch.where((s_idx == 0) | ((s_idx == 1) & (tl > 0)), 0.0, NEG)
    accept = torch.where(
        (s_idx == 2 * tl) | ((s_idx == 2 * tl - 1) & (tl > 0)), 0.0, NEG
    )
    return start, accept


def _accepted_score(alpha, target_lengths):
    """logaddexp of alpha [B, S] at the accepting states 2 len and 2 len - 1
    (only 2 len == 0 when len == 0)."""
    tl = target_lengths.long()
    last = torch.gather(alpha, 1, (2 * tl)[:, None])[:, 0]
    prev_idx = torch.clamp(2 * tl - 1, min=0)
    prev = torch.gather(alpha, 1, prev_idx[:, None])[:, 0]
    prev = torch.where(tl > 0, prev, NEG)
    return logaddexp(last, prev)


def ctc_forward_score(
    log_probs, targets, target_lengths, blank, input_lengths=None, impl="auto",
    chunk=None, seq_group=None,
):
    """Log-semiring forward score of the CTC lattice.

    Args:
      log_probs: ``[B, T, C]`` log probabilities.
      targets: ``[B, L]`` padded target indices.
      target_lengths: ``[B]`` true target lengths.
      blank: blank index.
      input_lengths: optional ``[B]`` true input lengths (default: T).
      impl: 'auto' (the kernel Function; 'chunked' past 4,096 frames),
        'scan' (plain recursion), 'assoc' (associative form over band
        operators, ``ctc_forward_score_assoc``) or 'chunked' (the kernel
        Function a chunk of frames at a time, O(T / chunk) memory between
        forward and backward).  'pallas' raises ``ValueError``.
      chunk: chunk size for 'assoc' (the chunk-transfer form) and
        'chunked' (default 128); None keeps each impl's default.
      seq_group: 'assoc' only: ``log_probs`` is this rank's time shard
        over the group (``ctc_forward_score_assoc``), ``input_lengths``
        global.

    Returns:
      ``[B]`` forward scores (log total path probability).
    """
    if seq_group is not None:
        if impl != "assoc":
            raise ValueError(f"a time-sharded CTC score needs impl 'assoc', not {impl!r}")
        return ctc_forward_score_assoc(log_probs, targets, target_lengths, blank,
                                       input_lengths, chunk, seq_group)
    B, T, _ = log_probs.shape
    device = log_probs.device
    S = 2 * targets.shape[1] + 1
    targets = targets.to(device)
    target_lengths = target_lengths.to(device)
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    input_lengths = input_lengths.to(device)

    if impl == "auto" and T > _MAX_WHOLE_T:
        impl = "chunked"
    if impl not in ("auto", "scan", "assoc", "chunked"):
        raise ValueError(f"unknown CTC impl {impl!r}")
    if impl == "assoc":
        return ctc_forward_score_assoc(
            log_probs, targets, target_lengths, blank, input_lengths, chunk
        )

    labels, skip_ok = ctc_state_tables(targets, blank)
    if impl in ("auto", "chunked"):
        # the kernels read the emissions from log_probs by label
        from .lattice_pallas import ctc_score_chunked, ctc_score_kernel

        start, accept = ctc_start_accept(target_lengths, S)
        if impl == "chunked":
            return ctc_score_chunked(log_probs, labels, start, accept, skip_ok,
                                     input_lengths, _CHUNK if chunk is None else chunk)
        return ctc_score_kernel(log_probs, labels, start, accept, skip_ok, input_lengths)

    # Emissions gathered into lattice states: [B, T, S]
    em = gather_channels(log_probs, labels)
    alpha = torch.full((B, S), NEG, dtype=em.dtype, device=device)
    alpha[:, 0] = em[:, 0, 0]
    # state 1 only exists when the target is non-empty
    alpha[:, 1] = torch.where(target_lengths > 0, em[:, 0, 1], NEG)

    def shift(x, k):
        return torch.cat([torch.full_like(x[:, :k], NEG), x[:, :-k]], dim=1)

    lens = input_lengths[:, None]
    for t in range(1, T):
        stay = alpha
        prev = shift(alpha, 1)
        skip = torch.where(skip_ok, shift(alpha, 2), NEG)
        new = em[:, t] + logsumexp_stack([stay, prev, skip])
        alpha = torch.where(t < lens, new, alpha)
    return _accepted_score(alpha, target_lengths)


def ctc_loss(
    log_probs,
    targets,
    target_lengths,
    blank,
    reduction="mean",
    input_lengths=None,
    impl="auto",
    chunk=None,
    seq_group=None,
):
    """Mean-over-batch negative CTC forward score.

    With reduction == 'mean' each sample's loss is scaled by 1/len(target)
    before the batch mean, as in the reference criterion.  ``seq_group``:
    ``log_probs`` is this rank's time shard (``ctc_forward_score``).
    """
    scores = ctc_forward_score(
        log_probs, targets, target_lengths, blank, input_lengths, impl, chunk, seq_group
    )
    losses = -scores
    if reduction == "mean":
        tl = target_lengths.to(losses.device)
        scale = torch.where(
            tl > 0, 1.0 / torch.clamp(tl, min=1).to(losses.dtype), 1.0
        )
        losses = losses * scale
    elif reduction != "none":
        raise ValueError(f"invalid value for reduction '{reduction}'")
    return torch.mean(losses)


def ctc_greedy_decode(outputs):
    """Framewise argmax [B, T, C] -> per-frame predictions [B, T].

    The repeat/blank collapse is ragged and happens host-side in the
    criterion wrapper.
    """
    return torch.argmax(outputs, dim=2)


def _assoc_combine(a, b):
    """(b o a)[i, j] = lse_k b[i, k] + a[k, j], a applied first: JAX's
    combine exactly, a per-entry max over k (no gradient) clamped at NEG
    and the sum floored at 1e-30 before its log."""
    x = b[..., :, :, None] + a[..., None, :, :]
    m = torch.clamp(torch.amax(x, dim=-2, keepdim=True), min=NEG).detach()
    s = torch.sum(torch.exp(x - m), dim=-2, keepdim=True)
    return (m + torch.log(torch.clamp(s, min=1e-30)))[..., 0, :]


def _fold(ops):
    """The composition of ops [n, ...] in time order (ops[0] applied
    first), a pairwise tree of ``_assoc_combine`` with log depth.  JAX runs
    ``lax.associative_scan``, which torch lacks, and reads only its last
    prefix, the composition of all; the tree computes that alone.  The
    order of the folds changes rounding only."""
    while ops.shape[0] > 1:
        n = ops.shape[0] // 2 * 2
        pairs = _assoc_combine(ops[0:n:2], ops[1:n:2])
        ops = torch.cat([pairs, ops[n:]], dim=0)
    return ops[0]


def _assoc_inputs(log_probs, targets, target_lengths, blank, input_lengths):
    B, T, _ = log_probs.shape
    device = log_probs.device
    targets = targets.to(device)
    target_lengths = target_lengths.to(device)
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    labels, skip_ok = ctc_state_tables(targets, blank)
    em = gather_channels(log_probs, labels)  # [B, T, S]
    return em, skip_ok, target_lengths, input_lengths.to(device)


def ctc_forward_score_assoc(
    log_probs, targets, target_lengths, blank, input_lengths=None, chunk=None,
    seq_group=None,
):
    """CTC forward score as a composition of band transition operators.

    The log-semiring recursion is associative, so the score is the
    composition of per-frame [S, S] operators ``M_t[s', s] = em[t, s'] +
    log(allowed(s -> s'))``, frame 0's diagonal (it consumes its emission
    without a transition), frames at t >= input_length the identity: JAX's
    sequence-sharding form (O(T S^3) work and O(T S^2) memory, log T
    depth).  The composition is ``_fold``'s pairwise tree.

    ``chunk``: the chunk-transfer form (``_ctc_assoc_chunked``), one dense
    operator a chunk of frames instead of one a frame.

    ``seq_group``: the sequence-parallel form over a ``torch.distributed``
    group of n ranks (the ``'seq'`` axis of ``parallel.mesh``).
    ``log_probs`` is then this rank's contiguous slice of T / n frames
    (group rank 0 holds frame 0; ``input_lengths`` count global frames, T
    by default).  Each rank composes its own frames' operators (or chunk
    transfers) into one [B, S, S] operator; the operators are gathered
    across the group and composed in rank order, the prefix combine JAX's
    XLA inserts across ``'seq'``.  Every rank returns the same score, and
    the gradient reaches each rank's own frames once
    (``parallel.mesh.all_gather_replicated``).

    Plain torch, as JAX computes it with jnp and lax: the recursion,
    combine and fold reach no Pallas kernel in JAX, so the port writes none;
    the emission gather (``semiring.gather_channels``) runs the gather
    kernels, as JAX's runs its Pallas gather on a TPU.
    """
    if seq_group is not None:
        return _ctc_assoc_seq(log_probs, targets, target_lengths, blank,
                              input_lengths, chunk, seq_group)
    if chunk is not None:
        return _ctc_assoc_chunked(
            log_probs, targets, target_lengths, blank, input_lengths, chunk
        )
    em, skip_ok, target_lengths, input_lengths = _assoc_inputs(
        log_probs, targets, target_lengths, blank, input_lengths)
    total = _fold(_frame_operators(em, skip_ok, input_lengths, 0, True))  # [B, S, S]
    return _accepted_score(_apply_start(total, target_lengths), target_lengths)


def _frame_operators(em, skip_ok, input_lengths, t0, first):
    """The per-frame operators [T, B, S, S] of frames t0.. of em [B, T, S]:
    stay, advance and skip where allowed, the identity for frames at t >=
    input_length, and, with ``first``, frame 0's diagonal."""
    B, T, S = em.shape
    device = em.device
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    eye, adv = i == j, i == j + 1
    skp = (i == j + 2)[None] & skip_ok[:, :, None]
    allowed = torch.where(eye[None] | adv[None] | skp, 0.0, NEG)

    ident = torch.where(eye, 0.0, NEG)[None, None]
    ops = em.transpose(0, 1)[:, :, :, None] + allowed[None]  # [T, B, S, S]
    ts = t0 + torch.arange(T, device=device)
    live = (ts[:, None] < input_lengths[None, :])[..., None, None]
    ops = torch.where(live, ops, ident)
    if first:
        ops0 = torch.where(eye[None], em[:, 0, :, None], NEG)
        ops = torch.cat([ops0[None], ops[1:]], dim=0)
    return ops


def _apply_start(total, target_lengths):
    """alpha at the last frame from the composed operator: the start
    potential (states 0 and, for a nonempty target, 1) folded into the
    apply; frame 0's operator already consumed its emission."""
    S = total.shape[-1]
    s_idx = torch.arange(S, device=total.device)[None, :]
    start = torch.where(
        (s_idx == 0) | ((s_idx == 1) & (target_lengths[:, None] > 0)), 0.0, NEG)
    return logsumexp(total + start[:, None, :], dim=-1)  # [B, S]


def _shift_rows(M, k):
    """M shifted down by k along its s_out axis (-2), NEG filled."""
    return torch.cat([torch.full_like(M[..., :k, :], NEG), M[..., :-k, :]], dim=-2)


def _chunk_transfers(em, ts, skip_ok, input_lengths, chunk, pad_t):
    """One dense [S, S] transfer a chunk of ``chunk`` frames, for all chunks
    at once as JAX's ``vmap`` does: [nc, B, S, S] from em [n, B, S] at
    global frames ``ts`` [n], the last chunk padded with frames at t =
    ``pad_t`` (the identity).  The in-chunk recursion runs under
    ``torch.utils.checkpoint``, as JAX's under ``jax.checkpoint``: the
    backward recomputes it rather than keep [B, S, S] a frame."""
    n_steps, B, S = em.shape
    device = em.device
    nc = max(-(-n_steps // chunk), 1)
    pad = nc * chunk - n_steps
    em_rest = torch.cat(
        [em, torch.zeros((pad, B, S), dtype=em.dtype, device=device)], dim=0
    ).reshape(nc, chunk, B, S)
    ts = torch.cat([
        ts, torch.full((pad,), pad_t, dtype=torch.long, device=device),
    ]).reshape(nc, chunk)

    skip = skip_ok[None, :, :, None]

    def frames(M, em_seg, ts_seg):
        for j in range(ts_seg.shape[1]):
            stay = M
            prev = _shift_rows(M, 1)
            jump = torch.where(skip, _shift_rows(M, 2), NEG)
            new = em_seg[:, j, :, :, None] + logsumexp_stack([stay, prev, jump])
            live = (ts_seg[:, j, None] < input_lengths[None, :])[..., None, None]
            M = torch.where(live, new, M)
        return M

    def transfers(em_rest):
        # M[c, b, i, j]: the score of reaching state i from state j across
        # the frames of chunk c seen so far; the identity to start.  The
        # backward's recompute runs segments of ~sqrt(chunk) frames, each
        # checkpointed again, so that it holds one segment's frames at a
        # time (the same numbers; JAX leaves that schedule to XLA)
        eye = torch.where(torch.eye(S, dtype=torch.bool, device=device), 0.0, NEG)
        M = eye.expand(nc, B, S, S)
        seg = max(1, math.isqrt(chunk))
        for j0 in range(0, chunk, seg):
            M = checkpoint(frames, M, em_rest[:, j0:j0 + seg], ts[:, j0:j0 + seg],
                           use_reentrant=False)
        return M

    return checkpoint(transfers, em_rest, use_reentrant=False)


def _ctc_assoc_chunked(
    log_probs, targets, target_lengths, blank, input_lengths, chunk
):
    """Chunk-transfer form of ``ctc_forward_score_assoc``: a banded
    in-chunk recursion builds one dense [S, S] transfer a chunk
    (``_chunk_transfers``); the transfers compose by ``_fold``.  Frame 0
    is the init, frames 1..T-1 split into chunks, the last padded with
    frames at t = T (the identity)."""
    em, skip_ok, target_lengths, input_lengths = _assoc_inputs(
        log_probs, targets, target_lengths, blank, input_lengths)
    B, T, S = em.shape
    device = em.device
    em = em.transpose(0, 1)  # [T, B, S]

    alpha0 = torch.full((B, S), NEG, dtype=em.dtype, device=device)
    alpha0[:, 0] = em[0, :, 0]
    if S > 1:
        alpha0[:, 1] = torch.where(target_lengths > 0, em[0, :, 1], NEG)

    total = _fold(_chunk_transfers(em[1:], torch.arange(1, T, device=device), skip_ok,
                                   input_lengths, chunk, T))
    alpha_final = logsumexp(total + alpha0[:, None, :], dim=-1)
    return _accepted_score(alpha_final, target_lengths)


def _ctc_assoc_seq(log_probs, targets, target_lengths, blank, input_lengths, chunk,
                   seq_group):
    """The sequence-parallel form of ``ctc_forward_score_assoc`` (see
    there): this rank's operator, gathered and composed in rank order."""
    import torch.distributed as dist

    from ..parallel import mesh

    rank, n = dist.get_rank(seq_group), dist.get_world_size(seq_group)
    B, T_local, _ = log_probs.shape
    t0 = rank * T_local
    if input_lengths is None:
        input_lengths = torch.full((B,), T_local * n, dtype=torch.int32)
    em, skip_ok, target_lengths, input_lengths = _assoc_inputs(
        log_probs, targets, target_lengths, blank, input_lengths)
    if chunk is None:
        local = _fold(_frame_operators(em, skip_ok, input_lengths, t0, rank == 0))
    else:
        # group rank 0's frame 0 is its diagonal operator, the others chunk
        # transfers from the rank's first frame on
        first = int(rank == 0)
        em_t = em.transpose(0, 1)
        ts = t0 + torch.arange(first, T_local, device=em.device)
        ops = _chunk_transfers(em_t[first:], ts, skip_ok, input_lengths, chunk,
                               T_local * n)
        if first:
            ops0 = _frame_operators(em[:, :1], skip_ok, input_lengths, 0, True)
            ops = torch.cat([ops0, ops], dim=0)
        local = _fold(ops)
    total = _fold(mesh.all_gather_replicated(local, seq_group))
    return _accepted_score(_apply_start(total, target_lengths), target_lengths)


# ---------------------------------------------------------------------------
# ASG
# ---------------------------------------------------------------------------


def asg_fcc_score(inputs, transitions, input_lengths=None):
    """Unconstrained ("fully connected") ASG forward score [B].

    ``transitions`` is the dense (N+1) x N matrix: entry [0, j] holds the
    start score of label j and entry [i+1, j] the score of label i
    following label j; every state accepts.  The log-semiring matvec is a
    real matrix product of max-shifted exponentials: with row shift ma and
    column shift mt, lse_i(alpha_i + trans_ij) = ma + mt_j +
    log(sum_i exp(alpha_i - ma) exp(trans_ij - mt_j)).  The shifts carry
    no gradient.
    """
    B, T, _ = inputs.shape
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    lens = input_lengths.to(inputs.device)[:, None]
    alpha = transitions[0][None, :] + inputs[:, 0]
    trans = transitions[1:].T  # [C, C], trans[i, j] = score of j after i
    mt = torch.amax(trans, dim=0).detach()
    exp_trans = torch.exp(trans - mt[None, :])
    for t in range(1, T):
        ma = torch.amax(alpha, dim=1, keepdim=True).detach()
        z = torch.exp(alpha - ma) @ exp_trans
        new = inputs[:, t] + ma + mt[None, :] + torch.log(torch.clamp(z, min=1e-37))
        alpha = torch.where(t < lens, new, alpha)
    return logsumexp(alpha, dim=1)


def _asg_chain_costs(transitions, targets):
    """Per-position stay and advance costs [B, L] of the target chain;
    position 0 advances from the start row."""
    B = targets.shape[0]
    self_cost = transitions[targets + 1, targets]
    prev_targets = torch.cat(
        [torch.zeros((B, 1), dtype=targets.dtype, device=targets.device),
         targets[:, :-1]], dim=1)
    adv_cost = transitions[targets + 1, prev_targets]
    start_cost = transitions[0, targets[:, 0]]
    return self_cost, torch.cat([start_cost[:, None], adv_cost[:, 1:]], dim=1)


def asg_fal_score(inputs, transitions, targets, target_lengths, input_lengths=None):
    """Force-aligned ASG score [B] through the target chain: position l
    emits targets[l]; staying pays p(tgt | tgt), advancing p(tgt_l |
    tgt_{l-1}), and the first emission the start score.  Targets are
    padded with 0 (a real label), as ``criterions.common.pad_targets``
    pads them."""
    B, T, _ = inputs.shape
    targets = targets.to(inputs.device).long()
    target_lengths = target_lengths.to(inputs.device)
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    lens = input_lengths.to(inputs.device)[:, None]

    em_tgt = gather_channels(inputs, targets)  # [B, T, L]
    self_cost, adv_cost = _asg_chain_costs(transitions, targets)
    neg_col = torch.full((B, 1), NEG, dtype=inputs.dtype, device=inputs.device)
    alpha = torch.cat([(adv_cost[:, 0] + em_tgt[:, 0, 0])[:, None],
                       neg_col.expand(B, targets.shape[1] - 1)], dim=1)
    for t in range(1, T):
        stay = alpha + self_cost
        prev = torch.cat([neg_col, alpha[:, :-1]], dim=1) + adv_cost
        new = em_tgt[:, t] + logaddexp(stay, prev)
        alpha = torch.where(t < lens, new, alpha)
    idx = torch.clamp(target_lengths.long() - 1, min=0)[:, None]
    score = torch.gather(alpha, 1, idx)[:, 0]
    return torch.where(target_lengths > 0, score, 0.0)


def asg_loss(inputs, transitions, targets, target_lengths, reduction="mean",
             input_lengths=None):
    """ASG criterion: free energy minus the force-aligned score, each
    sample's loss scaled by 1/len(target) under 'mean', then the batch
    mean."""
    fcc = asg_fcc_score(inputs, transitions, input_lengths)
    fal = asg_fal_score(inputs, transitions, targets, target_lengths, input_lengths)
    losses = fcc - fal
    if reduction == "mean":
        tl = target_lengths.to(losses.device)
        scale = torch.where(tl > 0, 1.0 / torch.clamp(tl, min=1).to(losses.dtype), 1.0)
        losses = losses * scale
    elif reduction != "none":
        raise ValueError(f"invalid value for reduction '{reduction}'")
    return torch.mean(losses)


@torch.no_grad()
def asg_viterbi_backpointers(outputs, transitions, input_lengths=None):
    """The tropical forward scan of the ASG decode: (backptrs [B, T-1, C]
    int32, last [B] int32, scores [B]).  Frames at t >= input_length keep
    the state (identity backpointers); ties go to the lowest index, as
    ``jnp.argmax`` breaks them."""
    B, T, C = outputs.shape
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    lens = input_lengths.to(outputs.device)[:, None]
    alpha = transitions[0][None, :] + outputs[:, 0]
    trans = transitions[1:].T  # trans[i, j] = score of j after i
    identity = torch.arange(C, device=outputs.device)[None, :].expand(B, C)
    backptrs = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None, :, :]  # [B, C_from, C_to]
        best_prev = torch.argmax(scores, dim=1)
        new = outputs[:, t] + torch.amax(scores, dim=1)
        live = t < lens
        alpha = torch.where(live, new, alpha)
        backptrs.append(torch.where(live, best_prev, identity))
    if backptrs:
        bp = torch.stack(backptrs, dim=1).to(torch.int32)
    else:
        bp = torch.zeros((B, 0, C), dtype=torch.int32, device=outputs.device)
    last = torch.argmax(alpha, dim=1).to(torch.int32)
    return bp, last, torch.amax(alpha, dim=1)


def asg_viterbi(outputs, transitions, input_lengths=None):
    """Tropical (Viterbi) decode through the dense ASG transition graph.

    Returns (paths [B, T] int32, scores [B]).  The backpointers are walked
    by ``dense_backtrace``: its CUDA kernel on CUDA tensors (no fallback),
    its plain walk on CPU tensors.  Host code collapses repeats, garbage
    and replabels (``criterions.asg``).
    """
    from .viterbi_scan_pallas import dense_backtrace

    bp, last, score = asg_viterbi_backpointers(outputs, transitions, input_lengths)
    return dense_backtrace(bp, last), score
