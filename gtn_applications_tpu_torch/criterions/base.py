"""Criterion protocol: host target preparation + a differentiable loss.

Counterpart of ``gtn_applications_tpu/criterions/base.py``.  Every
criterion follows the same split:

  * ``prepare(targets)``  — host-side: ragged targets -> padded tensors
    (shape-bucketed, so the lattice sees few distinct shapes).
  * ``loss(params, inputs, prepared, input_lengths)`` — differentiable in
    ``params`` and ``inputs``; ``seq_loss`` the same loss from this rank's
    time shard of ``inputs`` over a ``'seq'`` group.
  * ``init_params()`` — learnable parameters, a dict of tensors ({} when
    stateless).
  * ``viterbi(outputs, params)`` — decoding: device work + host cleanup,
    returning ragged int32 numpy arrays.
  * ``train()`` / ``eval()`` — the mode, which the drivers switch at each
    epoch's start and before evaluation (STC anneals only in training).

A criterion instance is also callable with stored parameters
(``crit(inputs, targets)``) for parity with the reference's module API.
"""


class Criterion:
    """Base class; subclasses implement the four methods above."""

    training = True

    def train(self):
        self.training = True
        return self

    def eval(self):
        self.training = False
        return self

    def init_params(self):
        return {}

    def prepare(self, targets):
        raise NotImplementedError

    def loss(self, params, inputs, prepared, input_lengths=None):
        raise NotImplementedError

    def seq_loss(self, params, inputs, prepared, input_lengths, seq_group):
        """``loss`` of the global batch from this rank's time shard of
        ``inputs`` [B, T / n, C] over ``seq_group`` (``input_lengths``
        global): the shards gathered along time, the gradient reaching
        each rank's own frames once (``parallel.mesh.gather_time``), and
        the whole-T route.  Every rank of the group returns the same loss."""
        from ..parallel import mesh

        return self.loss(params, mesh.gather_time(inputs, seq_group), prepared,
                         input_lengths)

    def viterbi(self, outputs, params=None, input_lengths=None):
        raise NotImplementedError

    # -- two-phase decode ----------------------------------------------
    # CUDA launches are asynchronous: eval loops call viterbi_dispatch for
    # a batch before viterbi_finalize reads the result back to the host.
    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        """Launch the device portion of decoding without blocking.  The
        default defers everything to finalize."""
        return (outputs, params, input_lengths)

    def viterbi_finalize(self, handle):
        outputs, params, input_lengths = handle
        return self.viterbi(outputs, params, input_lengths)

    # -- stateful convenience (reference nn.Module style) ---------------
    @property
    def params(self):
        if not hasattr(self, "_params"):
            self._params = self.init_params()
        return self._params

    @params.setter
    def params(self, value):
        self._params = value

    def __call__(self, inputs, targets, input_lengths=None):
        return self.loss(self.params, inputs, self.prepare(targets), input_lengths)
