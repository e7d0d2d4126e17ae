"""Star Temporal Classification criterion (PyTorch).

Counterpart of ``gtn_applications_tpu/criterions/stc.py``: training from
partially labeled sequences by appending a ``<star>`` channel (logsumexp of
all non-blank channels) and per-token ``<star>\\token`` channels
(log(exp(star) - exp(token))), then scoring a self-less-CTC-plus-star label
WFST with an annealed token insertion penalty
``p = plast + (p0 - plast) * 2^(-nstep / thalf)``.

Every STC graph state has a unique in-label, so the lattice is scored by
the dense-adjacency recursion (``ops.factored.alignment_lattice_score``,
whose ``dense_scan`` runs on the card's kernels).  The penalty enters as
``adj = adj0 + e^penalty * adj_star``, two host-built matrices.  A batch
that the dense tier's working-set gate refuses is scored by the sparse
tier, as in the JAX class: the graphs stacked into one arc table (a shared
union skeleton where the batch allows) whose star arcs carry the penalty
as their weight (``ops.sparse.forward_score_batch_tables``: the whole
sparse-scan kernels on the card).

Blank index is REQUIRED to be 0.
"""

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from ..ops import factored, sparse
from ..ops.semiring import NEG
from ..wfst import compile as wcompile
from ..wfst.graph import Graph
from .base import Criterion
from .ctc import CTC

# [B, S, S] adjacency + [B, S, C] label working-set gate (floats)
_DENSE_MAX_WORKSET = 48_000_000

STC_BLANK_IDX = 0

# Sentinel weight marking star arcs during host graph construction; the
# loss replaces it by the annealed log-penalty.
_STAR_SENTINEL = 1.0


def logsubexp(a, b):
    """log(exp(a) - exp(b)) with a 1e-7 guard; a: [B, T, 1], b: [B, T, K].
    The difference is clamped at zero (b <= a whenever b's mass is part
    of a's sum; the clamp only guards padded channels)."""
    return a + torch.log1p(1e-7 - torch.exp(torch.clamp(b - a, max=0.0)))


def make_stc_graph(target, star_idx):
    """STC label graph: a self-less CTC chain over the target (blank
    states ``bk[0..L]`` interleaved with token states ``tk[0..L-1]``, only
    blanks self-loop, tokens may skip the blank between them) plus one
    star state per inter-token gap.  Gap ``i`` (before token i; gap L is
    the tail) accepts ``<star>\\target[i]`` (plain ``<star>`` at the
    tail), is reachable from the gap's chain neighbours, loops on itself,
    and exits forward into token i or back to blank i.  Star arcs carry
    the sentinel weight that ``loss`` swaps for the log penalty."""
    g = Graph()
    L = len(target)
    # chain states, interleaved: b0 t0 b1 t1 ... t_{L-1} bL, then the stars
    bk, tk = [], []
    for i in range(L + 1):
        bk.append(g.add_node(i == 0, i == L))
        if i < L:
            tk.append(g.add_node(False, i == L - 1))
    for i, b in enumerate(bk):
        g.add_arc(b, b, STC_BLANK_IDX)
        if i > 0:
            g.add_arc(tk[i - 1], b, STC_BLANK_IDX)
    for i, t in enumerate(tk):
        g.add_arc(bk[i], t, target[i])
        if i > 0:
            g.add_arc(tk[i - 1], t, target[i])
    for i in range(L + 1):
        star = g.add_node(False, i == L)
        chan = star_idx if i == L else star_idx + target[i]
        into = ([] if i == 0 else [tk[i - 1]]) + [bk[i]]
        for src in into + [star]:
            g.add_arc(src, star, chan, chan, _STAR_SENTINEL)
        if i < L:
            g.add_arc(star, tk[i], target[i])
        g.add_arc(star, bk[i], STC_BLANK_IDX)
    return g


class STC(Criterion):
    """STC loss.

    Args:
      blank_idx: must be 0.
      p0 / plast / thalf: insertion penalty annealing schedule.
      reduction: 'none' or 'mean' (divide per-sample loss by T).
      shift_targets: added to every target id (the factory sets 1, so the
        dataset's 0-based ids move past the blank).
    """

    def __init__(self, blank_idx=0, p0=1.0, plast=1.0, thalf=1.0,
                 reduction="none", shift_targets=0):
        assert blank_idx == STC_BLANK_IDX
        self.p0 = p0
        self.plast = plast
        self.thalf = thalf
        self.nstep = 0
        self.reduction = reduction
        self.shift_targets = shift_targets
        self._graph_cache: Dict[tuple, tuple] = {}
        self._greedy = CTC(blank=STC_BLANK_IDX)

    def _compiled(self, target, star_idx):
        key = (target, star_idx)
        hit = self._graph_cache.get(key)
        if hit is None:
            g = make_stc_graph(list(target), star_idx)
            cg = wcompile.compile_acceptor(g)
            star_mask = (cg.weight == _STAR_SENTINEL).astype(np.float32)
            hit = (cg._replace(weight=cg.weight * (1.0 - star_mask)), star_mask)
            if len(self._graph_cache) > 100000:
                self._graph_cache.clear()
            self._graph_cache[key] = hit
        return hit

    def prepare(self, targets, select_multiple=8):
        """Host: per-batch token subsetting, target remapping, STC graph
        compilation to dense tables (an arc table where the dense gate refuses
        the batch), and the annealed penalty (a host
        float).  The annealing step counts only in training mode."""
        if self.training:
            self.nstep += 1
        prob = self.plast + (self.p0 - self.plast) * math.exp(
            -self.nstep * math.log(2) / self.thalf
        )

        targets = [
            [int(t) + self.shift_targets for t in np.asarray(tgt).reshape(-1)]
            for tgt in targets
        ]
        select = [STC_BLANK_IDX] + sorted(set(t for tgt in targets for t in tgt))
        target_map = {t: i for i, t in enumerate(select)}
        # pad the selection to a bucketed size with blank (the graphs never
        # reference padded channels)
        Csel = ((len(select) + select_multiple - 1) // select_multiple) * select_multiple
        select_padded = select + [STC_BLANK_IDX] * (Csel - len(select))
        star_idx = Csel

        remapped = [tuple(target_map[t] for t in tgt) for tgt in targets]
        compiled = [self._compiled(tgt, star_idx) for tgt in remapped]
        prepared = {
            "select": torch.as_tensor(select_padded, dtype=torch.int64),
            "log_penalty": math.log(prob),
        }
        dense = self._prepare_dense(compiled, Csel)
        if dense is not None:
            prepared["dense"] = dense
        else:
            prepared["table"], prepared["star_mask"] = self._prepare_sparse(compiled)
        return prepared

    @staticmethod
    def _prepare_sparse(compiled):
        """One arc table of the batch's graphs (union skeleton or stacked)
        and the [B, A] mask of its star arcs."""
        cgs = [c[0] for c in compiled]
        union = wcompile.union_stack_arc_tables(cgs)
        if union is not None:
            table, positions, _ = union
            star_mask = np.zeros((len(cgs), table.src.shape[0]), np.float32)
            for b, c in enumerate(compiled):
                star_mask[b, positions[b]] = c[1]
        else:
            table = wcompile.stack_arc_tables(cgs)
            A = table.src.shape[1]
            star_mask = np.stack([np.concatenate([c[1], np.zeros(A - len(c[1]), np.float32)])
                                  for c in compiled])
        return table, torch.from_numpy(star_mask)

    def _prepare_dense(self, compiled, Csel):
        """Dense-adjacency tables for ``alignment_lattice_score``: adj0
        holds the non-star arcs, adj_star the star arcs at unit base
        weight (scaled by e^penalty in the loss).  None when a sample has
        epsilon arcs or mixed in-labels (neither occurs for
        ``make_stc_graph`` output) or the working set exceeds the gate."""
        C_em = 2 * Csel
        B = len(compiled)
        S = -(-max(len(c[0].start) for c in compiled) // 8) * 8
        if B * S * (S + C_em) > _DENSE_MAX_WORKSET:
            return None
        adj0 = np.zeros((B, S, S), np.float32)
        adj_star = np.zeros((B, S, S), np.float32)
        lab_oh = np.zeros((B, S, C_em), np.float32)
        start = np.full((B, S), NEG, np.float32)
        accept = np.full((B, S), NEG, np.float32)
        for b, (cg, smask) in enumerate(compiled):
            if len(cg.eps_src) > 0:
                return None
            lab = cg.label.astype(np.int64)
            n = len(cg.start)
            lo = np.full((n,), 2**31, np.int64)
            np.minimum.at(lo, cg.dst, lab)
            hi = np.full((n,), -1, np.int64)
            np.maximum.at(hi, cg.dst, lab)
            entered = hi >= 0
            if np.any(lo[entered] != hi[entered]) or (
                lab.size and lab.max() >= C_em
            ):
                return None
            ew = np.exp(cg.weight)
            np.add.at(adj0[b], (cg.dst, cg.src), ew * (1.0 - smask))
            np.add.at(adj_star[b], (cg.dst, cg.src), ew * smask)
            states = np.nonzero(entered)[0]
            lab_oh[b, states, hi[states]] = 1.0
            start[b, :n] = cg.start
            accept[b, :n] = cg.accept
        return {
            "adj0": torch.from_numpy(adj0),
            "adj_star": torch.from_numpy(adj_star),
            "lab_oh": torch.from_numpy(lab_oh),
            "start": torch.from_numpy(start),
            "accept": torch.from_numpy(accept),
        }

    def star_channels(self, log_probs, select):
        """Append <star> and <star>\\token channels."""
        lse = torch.logsumexp(log_probs[:, :, 1:], dim=2, keepdim=True)
        sel = torch.index_select(log_probs, 2, select.to(log_probs.device))
        neglse = logsubexp(lse, sel[:, :, 1:])
        return torch.cat([sel, lse, neglse], dim=2)

    def loss(self, params, inputs, prepared, input_lengths=None):
        """inputs: [B, T, C] logits or log probabilities, blank at channel 0
        (log_softmax is idempotent)."""
        B, T, C = inputs.shape
        inputs = torch.log_softmax(inputs, dim=2)
        em = self.star_channels(inputs, prepared["select"])
        if "dense" in prepared:
            d = prepared["dense"]
            adj = d["adj0"] + math.exp(prepared["log_penalty"]) * d["adj_star"]
            scores = factored.alignment_lattice_score(
                em, adj, d["lab_oh"], d["start"], d["accept"], input_lengths
            )
        else:
            table = prepared["table"]
            weight = table.weight + prepared["star_mask"] * prepared["log_penalty"]
            scores = sparse.forward_score_batch_tables(
                em, dataclasses.replace(table, weight=weight), input_lengths)
        losses = -scores
        if self.reduction == "mean":
            losses = losses / T
        elif self.reduction != "none":
            raise ValueError(f"invalid value for reduction '{self.reduction}'")
        return torch.mean(losses)

    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        return self._greedy.viterbi_dispatch(outputs, None, input_lengths)

    def viterbi_finalize(self, handle):
        """Greedy decode with repeat/blank collapse (STC trains a standard
        emission model), shifted back to the dataset's 0-based ids."""
        preds = self._greedy.viterbi_finalize(handle)
        if self.shift_targets:
            preds = [p - self.shift_targets for p in preds]
        return preds

    def viterbi(self, outputs, params=None, input_lengths=None):
        return self.viterbi_finalize(
            self.viterbi_dispatch(outputs, params, input_lengths)
        )
