"""Connectionist Temporal Classification criterion (PyTorch).

Counterpart of ``gtn_applications_tpu/criterions/ctc.py``.  The lattice is
a batched fixed-shape recursion on the device (``ops.lattice.ctc_loss``),
whose gradient is the exact posterior marginals from the CTC kernel pair.
The port never calls a library CTC: the reference's ``use_pt`` flag is
accepted and ignored.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import utils
from ..ops import lattice
from .base import Criterion
from .common import pad_targets


class CTC(Criterion):
    """CTC loss.

    Args:
      blank: index of the blank label (the reference appends blank last:
        output_size = num_tokens + 1).
      use_pt: accepted and ignored (the reference's switch to the library
        CTC; the port's runs on its own kernels either way).
      impl: lattice implementation, 'auto' (kernel; 'chunked' past 4,096
        frames), 'scan', 'assoc' or 'chunked' (``ops.lattice``).
      chunk: chunk size for 'assoc' (the chunk-transfer form) and
        'chunked'; None keeps each impl's default.
    """

    def __init__(self, blank, use_pt=True, impl="auto", chunk=None):
        self.blank = blank
        self.impl = impl
        self.chunk = chunk

    def prepare(self, targets):
        return pad_targets(targets)

    def loss(self, params, inputs, prepared, input_lengths=None, seq_group=None):
        """The batch-mean loss; with ``seq_group`` (impl 'assoc'),
        ``inputs`` is this rank's time shard (``seq_loss``)."""
        targets, target_lengths = prepared
        log_probs = F.log_softmax(inputs, dim=2)
        return lattice.ctc_loss(
            log_probs, targets, target_lengths, self.blank, "mean",
            input_lengths, self.impl, self.chunk, seq_group,
        )

    def seq_loss(self, params, inputs, prepared, input_lengths, seq_group):
        """Under 'assoc' the sequence-parallel form: each rank composes its
        own frames' operators (``ops.lattice.ctc_forward_score_assoc``);
        every other impl gathers the shards along time and runs its
        whole-T route (``Criterion.seq_loss``)."""
        if self.impl != "assoc":
            return super().seq_loss(params, inputs, prepared, input_lengths, seq_group)
        return self.loss(params, inputs, prepared, input_lengths, seq_group)

    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        return (lattice.ctc_greedy_decode(outputs), input_lengths)

    def viterbi_finalize(self, handle):
        preds, input_lengths = handle
        return self._collapse(utils.to_host(preds).numpy(), input_lengths)

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
            lens = np.asarray(utils.to_host(torch.as_tensor(input_lengths)))
            keep &= np.arange(T)[None, :] < lens[:, None]
        return [preds[b, keep[b]].astype(np.int32) for b in range(B)]
