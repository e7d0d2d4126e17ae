"""Connectionist Temporal Classification criterion (PyTorch).

Counterpart of ``gtn_applications_tpu/criterions/ctc.py``.  The lattice is
a batched fixed-shape recursion on the device (``ops.lattice.ctc_loss``),
whose gradient is the exact posterior marginals from the CTC kernel pair.
The port never calls a library CTC, so the reference's ``use_pt`` flag
has no counterpart.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import lattice
from .base import Criterion
from .common import pad_targets


class CTC(Criterion):
    """CTC loss.

    Args:
      blank: index of the blank label (the reference appends blank last:
        output_size = num_tokens + 1).
      impl: lattice implementation, 'auto' (kernel) or 'scan'.
    """

    def __init__(self, blank, impl="auto"):
        self.blank = blank
        self.impl = impl

    def prepare(self, targets):
        return pad_targets(targets)

    def loss(self, params, inputs, prepared, input_lengths=None):
        targets, target_lengths = prepared
        log_probs = F.log_softmax(inputs, dim=2)
        return lattice.ctc_loss(
            log_probs, targets, target_lengths, self.blank, "mean",
            input_lengths, self.impl,
        )

    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        return (lattice.ctc_greedy_decode(outputs), input_lengths)

    def viterbi_finalize(self, handle):
        preds, input_lengths = handle
        return self._collapse(preds.cpu().numpy(), input_lengths)

    def viterbi(self, outputs, params=None, input_lengths=None):
        """Greedy best-path decode with repeat/blank collapse.  Returns a
        list of 1-D int32 numpy arrays."""
        return self.viterbi_finalize(
            self.viterbi_dispatch(outputs, params, input_lengths)
        )

    def _collapse(self, preds, input_lengths):
        B, T = preds.shape
        keep = np.ones((B, T), dtype=bool)
        keep[:, 1:] = preds[:, 1:] != preds[:, :-1]
        keep &= preds != self.blank
        if input_lengths is not None:
            lens = np.asarray(torch.as_tensor(input_lengths).cpu())
            keep &= np.arange(T)[None, :] < lens[:, None]
        return [preds[b, keep[b]].astype(np.int32) for b in range(B)]
