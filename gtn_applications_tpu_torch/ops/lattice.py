"""Batched CTC lattice dynamic program (PyTorch), CTC half.

Counterpart of the CTC half of ``gtn_applications_tpu/ops/lattice.py``.  The
criterion graph is a chain with self-loops and bounded skips, so the
composition with the emissions collapses to gathering emission channels
into the 2L+1 lattice states; the score is a fixed-shape recursion over
``[B, S]`` state tensors.

``impl="auto"`` runs the kernel ``Function`` of ``ops/lattice_pallas.py``:
its CUDA kernels on CUDA tensors, its plain versions on CPU tensors.
``impl="scan"`` is a plain-torch copy of the JAX ``lax.scan`` path (a
second oracle).  The associative-scan and chunked forms are not ported
yet (ROADMAP queue A item 11, "Long-sequence CTC").
"""

import torch

from .semiring import NEG, gather_channels, logaddexp, logsumexp_stack

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
