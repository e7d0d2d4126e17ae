"""Batched lattice dynamic programs (PyTorch): the CTC and ASG halves.

Counterpart of the CTC and ASG halves of ``gtn_applications_tpu/ops/lattice.py``.  The
criterion graph is a chain with self-loops and bounded skips, so the
composition with the emissions collapses to gathering emission channels
into the 2L+1 lattice states; the score is a fixed-shape recursion over
``[B, S]`` state tensors.

``impl="auto"`` runs the kernel ``Function`` of ``ops/lattice_pallas.py``:
its CUDA kernels on CUDA tensors, its plain versions on CPU tensors.
``impl="scan"`` is a plain-torch copy of the JAX ``lax.scan`` path (a
second oracle).  The associative-scan and chunked forms are not ported
yet (ROADMAP queue A item 11, "Long-sequence CTC").

ASG: the free energy is a max-shifted exp-matmul scan against the dense
transition matrix (plain ``torch.matmul``, as JAX leaves it to XLA), the
force-aligned score a banded recursion over emissions gathered by the
gather kernel, and the Viterbi decode a max/argmax scan whose backpointers
the dense backtrace kernel walks (``ops/viterbi_scan_pallas.py``).
"""

import torch

from .semiring import NEG, gather_channels, logaddexp, logsumexp, logsumexp_stack

# Beyond this many frames the JAX package routes "auto" to the chunked scan,
# which the port does not have yet.
_MAX_KERNEL_T = 4096


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


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A item 11, "
        "Long-sequence CTC)"
    )


def ctc_forward_score(
    log_probs, targets, target_lengths, blank, input_lengths=None, impl="auto",
):
    """Log-semiring forward score of the CTC lattice.

    Args:
      log_probs: ``[B, T, C]`` log probabilities.
      targets: ``[B, L]`` padded target indices.
      target_lengths: ``[B]`` true target lengths.
      blank: blank index.
      input_lengths: optional ``[B]`` true input lengths (default: T).
      impl: 'auto' (the kernel Function) or 'scan' (plain recursion).
        'assoc' and 'chunked' are not ported.

    Returns:
      ``[B]`` forward scores (log total path probability).
    """
    B, T, _ = log_probs.shape
    device = log_probs.device
    S = 2 * targets.shape[1] + 1
    targets = targets.to(device)
    target_lengths = target_lengths.to(device)
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    input_lengths = input_lengths.to(device)

    if impl in ("assoc", "chunked"):
        raise _not_ported(f"CTC impl={impl!r}")
    if impl not in ("auto", "scan"):
        raise ValueError(f"unknown CTC impl {impl!r}")

    if impl == "auto" and T > _MAX_KERNEL_T:
        raise _not_ported(f"CTC over T={T} > {_MAX_KERNEL_T} frames")

    labels, skip_ok = ctc_state_tables(targets, blank)
    # Emissions gathered into lattice states: [B, T, S]
    em = gather_channels(log_probs, labels)

    if impl == "auto":
        from .lattice_pallas import ctc_score_kernel

        start, accept = ctc_start_accept(target_lengths, S)
        return ctc_score_kernel(em, start, accept, skip_ok, input_lengths)

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

    # Accepting states are 2*len and 2*len - 1 (only 2*len == 0 when len == 0).
    tl = target_lengths.long()
    last = torch.gather(alpha, 1, (2 * tl)[:, None])[:, 0]
    prev_idx = torch.clamp(2 * tl - 1, min=0)
    prev = torch.gather(alpha, 1, prev_idx[:, None])[:, 0]
    prev = torch.where(tl > 0, prev, NEG)
    return logaddexp(last, prev)


def ctc_loss(
    log_probs,
    targets,
    target_lengths,
    blank,
    reduction="mean",
    input_lengths=None,
    impl="auto",
):
    """Mean-over-batch negative CTC forward score.

    With reduction == 'mean' each sample's loss is scaled by 1/len(target)
    before the batch mean, as in the reference criterion.
    """
    scores = ctc_forward_score(
        log_probs, targets, target_lengths, blank, input_lengths, impl
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
