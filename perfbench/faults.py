"""Faults planted in the port, for the check's own tests and for the
readings its limits are set from: each context manager breaks the timed
path underneath the harness, which runs unchanged.

- ``unchanged_state``: the train step returns its state unchanged;
- ``half_batch``: the loss leaves out half the batch and takes the mean
  over the rest (CTC's and the Transducer's reductions);
- ``altered_token``: a decoded token altered where it is produced.
"""

from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextmanager
def unchanged_state():
    from gtn_applications_tpu_torch import train as pt

    def make(orig):
        def make_train_step(model, *args, **kwargs):
            step = orig(model, *args, **kwargs)

            def faulty(*a, **k):
                saved = [p.detach().clone() for p in model.parameters()]
                out = step(*a, **k)
                with torch.no_grad():
                    for p, v in zip(model.parameters(), saved):
                        p.copy_(v)
                return out
            return faulty
        return make_train_step

    with _patched(pt, "make_train_step", make):
        yield


@contextmanager
def half_batch():
    from gtn_applications_tpu_torch.criterions.transducer import Transducer
    from gtn_applications_tpu_torch.ops import lattice

    def make_ctc(orig):
        def ctc_loss(log_probs, targets, target_lengths, blank, reduction="mean",
                     input_lengths=None, *rest):
            h = max(1, log_probs.shape[0] // 2)
            lens = None if input_lengths is None else input_lengths[:h]
            scores = lattice.ctc_forward_score(log_probs[:h], targets[:h], target_lengths[:h],
                                               blank, lens, *rest)
            tl = target_lengths[:h].to(scores.device).clamp(min=1).to(scores.dtype)
            return torch.mean(-scores / tl)
        return ctc_loss

    def make_reduce(orig):
        def _reduce(self, losses, prepared):
            h = max(1, losses.shape[0] // 2)
            return orig(self, losses[:h], {"target_lengths": prepared["target_lengths"][:h]})
        return _reduce

    with _patched(lattice, "ctc_loss", make_ctc), \
            _patched(Transducer, "_reduce", make_reduce):
        yield


@contextmanager
def altered_token():
    from gtn_applications_tpu_torch.criterions.ctc import CTC
    from gtn_applications_tpu_torch.criterions.transducer import Transducer

    def make(orig, num_tokens):
        def viterbi_finalize(self, handle):
            out = orig(self, handle)
            first = np.array(out[0], dtype=np.int32)
            if len(first):
                first[0] = (first[0] + 1) % num_tokens(self)
            else:
                first = np.zeros(1, np.int32)
            out[0] = first
            return out
        return viterbi_finalize

    with _patched(CTC, "viterbi_finalize", lambda o: make(o, lambda c: c.blank)), \
            _patched(Transducer, "viterbi_finalize", lambda o: make(o, lambda c: c._num_tokens)):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_token": altered_token}
