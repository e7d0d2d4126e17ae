"""Dense-adjacency alignment-lattice scoring (PyTorch).

Counterpart of ``alignment_lattice_score`` in
``gtn_applications_tpu/ops/factored.py``: the forward score of per-sample
alignment lattices in which every state has a unique in-label, as one
``[B, S] x [B, S, S]`` exp-matvec per frame.  The recursion runs through
``dense_scan`` (``ops/dense_scan_pallas.py``): its CUDA kernels on CUDA
tensors, its plain versions on CPU tensors.  The JAX package leaves that
whole-scan kernel opt-in because the TPU's per-grid-step overhead lost to
XLA's loop; on the H100 one block per sample with the time loop inside has
no such overhead, so the port always takes it (with the JAX floor of
1e-37, ``dense_scan_pallas._FLOOR``).  The transition-factored
scorers of that file wait for ROADMAP queue A item 8.
"""

import torch

from .dense_scan_pallas import dense_scan
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
