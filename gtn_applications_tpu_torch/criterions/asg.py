"""Auto-Segmentation (ASG) criterion (PyTorch).

Counterpart of ``gtn_applications_tpu/criterions/asg.py``: a learned dense
``(N+1) x N`` transition matrix (entry [0, j] = start score of j, entry
[i+1, j] = score of label i following label j), loss = the log-sum over all
paths minus the force-aligned score through the target chain
(``ops.lattice.asg_loss``), replabel packing and optional garbage-token
interleaving.  The transition gradient comes from autograd.

Decoding is the tropical scan of ``ops.lattice.asg_viterbi``, whose
backpointers the dense backtrace kernel walks on the card.  Unlike the JAX
class, there is no silent retry with another backtrace: on a CUDA tensor
the kernel runs or the call raises.  The host cleanup takes the native
``asg_collapse`` where ``wfst.native.enabled()``, as JAX's does, else the
Python ``_cleanup`` (also its test oracle).  ``create_transitions_graph``
builds the transition matrix's WFST, in the arc order of the matrix's
row-major layout.
"""

import numpy as np
import torch

from .. import utils
from ..ops import lattice
from ..wfst import native
from ..wfst.graph import Graph
from .base import Criterion
from .common import pad_targets


def _run_length_encode(seq):
    """[(value, run_length)] pairs over maximal runs of equal values."""
    runs = []
    for item in seq:
        if runs and runs[-1][0] == item:
            runs[-1][1] += 1
        else:
            runs.append([item, 1])
    return runs


def pack_replabels(tokens, num_replabels):
    """Encode consecutive repeats with repeat labels.

    Repeat labels occupy ids 0..num_replabels-1 (label k means "the previous
    token occurred k+1 more times"); real token ids shift up by
    num_replabels.  A run longer than num_replabels+1 is split greedily.
    Nested lists are packed one by one.
    """
    if len(tokens) > 0 and all(isinstance(t, (list, tuple)) for t in tokens):
        return [pack_replabels(t, num_replabels) for t in tokens]
    packed = []
    for tok, count in _run_length_encode(tokens):
        while count > 0:
            span = min(count, num_replabels + 1)
            packed.append(int(tok) + num_replabels)
            if span > 1:
                packed.append(span - 2)
            count -= span
    return packed


def unpack_replabels(tokens, num_replabels):
    """Inverse of :func:`pack_replabels`.  A repeat label with no real
    token just before it is dropped."""
    if len(tokens) > 0 and all(isinstance(t, (list, tuple)) for t in tokens):
        return [unpack_replabels(t, num_replabels) for t in tokens]
    decoded = []
    expandable = False
    for tok in tokens:
        if tok >= num_replabels:
            decoded.append(int(tok) - num_replabels)
            expandable = True
        elif expandable:
            decoded.extend([decoded[-1]] * (int(tok) + 1))
            expandable = False
    return decoded


def create_transitions_graph(transitions):
    """Dense ASG transition matrix -> WFST: node 0 is the start, node i+1
    accepts label i; arc order (start arcs, then the (i, j) double loop)
    follows the matrix's row-major layout, so that arc weights and
    transition parameters index alike."""
    transitions = np.asarray(transitions)
    num_classes = transitions.shape[1]
    assert transitions.shape == (num_classes + 1, num_classes)
    g = Graph()
    g.add_node(True)
    for i in range(1, num_classes + 1):
        g.add_node(False, True)
        g.add_arc(0, i, i - 1, i - 1, float(transitions[0, i - 1]))
    for i in range(num_classes):
        for j in range(num_classes):
            g.add_arc(j + 1, i + 1, i, i, float(transitions[i + 1, j]))
    return g


class ASG(Criterion):
    """ASG loss with learned transitions."""

    def __init__(self, num_classes, num_replabels=1, use_garbage=True):
        # num_replabels = 0 means no replabel packing
        assert num_replabels >= 0
        self.num_classes = num_classes
        self.num_replabels = num_replabels
        self.use_garbage = use_garbage
        self.garbage_idx = num_classes + num_replabels if use_garbage else None
        self.N = num_classes + num_replabels + int(use_garbage)

    def init_params(self):
        return {"transitions": torch.zeros((self.N + 1, self.N))}

    def prepare(self, targets):
        """Host transform: replabel packing + garbage interleave + padding."""
        packed = [
            pack_replabels(list(np.asarray(t)), self.num_replabels) for t in targets
        ]
        if self.garbage_idx is not None:
            out = []
            for tgt in packed:
                g = [self.garbage_idx] * (len(tgt) * 2 + 1)
                g[1::2] = tgt
                out.append(g)
            packed = out
        return pad_targets(packed)

    def loss(self, params, inputs, prepared, input_lengths=None):
        targets, target_lengths = prepared
        return lattice.asg_loss(
            inputs, params["transitions"], targets, target_lengths, "mean",
            input_lengths,
        )

    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        params = params if params is not None else self.params
        transitions = params["transitions"].detach().to(outputs.device)
        paths, _ = lattice.asg_viterbi(outputs.detach(), transitions, input_lengths)
        return (paths, input_lengths)

    def viterbi_finalize(self, handle):
        paths, input_lengths = handle
        paths = utils.to_host(paths).numpy()
        if native.enabled():
            if input_lengths is not None:
                input_lengths = utils.to_host(torch.as_tensor(input_lengths)).numpy()
            return native.asg_collapse(
                paths, input_lengths, self.garbage_idx, self.num_replabels)
        return self._cleanup(paths, input_lengths)

    def viterbi(self, outputs, params=None, input_lengths=None):
        """Device tropical scan + host cleanup."""
        return self.viterbi_finalize(
            self.viterbi_dispatch(outputs, params, input_lengths)
        )

    def _cleanup(self, paths, input_lengths):
        if input_lengths is not None:
            input_lengths = np.asarray(utils.to_host(torch.as_tensor(input_lengths)))
        out = []
        for b, path in enumerate(paths):
            if input_lengths is not None:
                path = path[: int(input_lengths[b])]
            collapsed = [
                int(p) for i, p in enumerate(path) if i == 0 or p != path[i - 1]
            ]
            if self.garbage_idx is not None:
                collapsed = [p for p in collapsed if p != self.garbage_idx]
            out.append(
                np.asarray(
                    unpack_replabels(collapsed, self.num_replabels), dtype=np.int32
                )
            )
        return out
