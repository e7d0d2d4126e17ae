"""Dense-adjacency alignment-lattice scoring (PyTorch).

Counterpart of ``alignment_lattice_score``, ``factored_lattice_score``,
``dense_ngram_norm`` and ``ngram_rows`` in
``gtn_applications_tpu/ops/factored.py``: the forward score of per-sample
alignment lattices in which every state has a unique in-label, without a
transition factor (one ``[B, S] x [B, S, S]`` exp-matvec per frame) or
under a full bigram transition model, and the normaliser of that model.
The recursions run through ``dense_scan`` and ``factored_scan``
(``ops/dense_scan_pallas.py``): their CUDA kernels on CUDA tensors, their
plain versions on CPU tensors.  The JAX package leaves those whole-scan
kernels opt-in (``GTN_DENSE_SCAN``) because the TPU's per-grid-step
overhead lost to XLA's loop, and trains the bigram scorer through an
analytic-VJP fold instead; on the H100 one block per sample with the time
loop inside has no such overhead, so the port always takes the kernels
(with the JAX floor of 1e-37, ``dense_scan_pallas._FLOOR``).  The backoff
scorers and ``factored_vjp`` wait for ROADMAP queue A item 8.

The einsums around the scans must run in full fp32: the drivers switch
TF32 off (``train.select_device``), since reduced precision there costs
whole nats over T frames (measured on the JAX side, ``factored.py``).
"""

import torch

from .dense_scan_pallas import _FLOOR, dense_scan, factored_scan
from .semiring import DEAD, NEG, logsumexp


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
