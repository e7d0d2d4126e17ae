"""Generic WFST transducer criterion (PyTorch).

Counterpart of ``gtn_applications_tpu/criterions/transducer.py``: the
reference composes, per sample, the target chain with a lexicon (wordpiece
decompositions), then with a token graph (alignments over emission labels)
and optionally with a transition model, and scores the result against the
emissions.  Here the per-target pipeline runs once per distinct target in
the native graph compiler (``wfst.native.compile_alignment``), cached, or,
where the library is not enabled (``TW_NATIVE=0``), through JAX's Python
pipeline on ``wfst.ops``; the device recursions score its tables:

  * ``ngram`` 1 or 2: the transition weight between two alignment arcs
    depends only on their labels, so the plain alignment lattice is packed
    into dense tables and scored under a bigram factor
    (``ops.factored.factored_lattice_score``, whose ``factored_scan`` runs
    on the card's kernels) and normalised by the dense n-gram lattice
    (``dense_ngram_norm``);
  * no transitions: the log-softmaxed emissions through the dense
    alignment lattice (``alignment_lattice_score`` and ``dense_scan``);
  * a loaded transition graph (a pruned backoff n-gram with epsilon
    backoff arcs, ``scripts/build_transitions.py``) under
    ``GTN_TRANSDUCER_FACTORED=on``: the plain lattices against the graph
    over a dense context axis, without composing
    (``ops.factored.backoff_factored_score`` and ``backoff_dense_norm``
    where the [N, S_c, S_c] matrices fit; else, for a graph whose label
    decides an advance arc's destination, ``backoff_dst_factored_score``
    and ``backoff_dst_norm`` over [S_c, N] matrices, with the low-rank
    epsilon closure on the exp-linear tier);
  * the composed path: a loaded graph otherwise, ``ngram`` > 2, every
    batch under ``GTN_TRANSDUCER_FACTORED=off``, and any batch that the
    dense packing refuses.  The transitions are composed into each
    sample's lattice on the host, with the provenance ``widx``/``eps_widx``
    of every arc's learnable weight, and stacked into one arc table (a
    shared union skeleton where the batch allows); the loss is its forward
    score less that of the transition graph alone
    (``ops.sparse.forward_score_batch_tables`` and ``forward_score_batch``:
    the ``seg_lse`` and whole sparse-scan kernels on the card).

JAX factors a loaded graph under ``auto`` only on the TPU, where segment
ops are pathological; the card runs them through hand-written kernels, so
the port's ``auto`` composes it on every device (``on`` factors it).
Decoding with transitions goes through a decode template of the
transition graph (``wfst.compile``) and ``ops.sparse.viterbi_batch``: the
whole-scan Viterbi where its in-degree bucket plan takes the table, else
(a loaded LM whose epsilon-removed table has a hub state) the per-step
``seg_max`` decode; a destination-factorable graph with S_c * N > 2^15
(every 1k-wordpiece LM), whose epsilon-removed table would hold ~S_c * N
arcs, decodes through ``ops.factored.backoff_dst_viterbi`` instead, as in
JAX, whatever the routing switch says; without transitions, it is an
argmax.  The alignment labels transduce to tokens by a run collapse, with
``blank="forced"`` through the native ``forced_collapse``, or the token
graph in Python without the library (infeasible alignments decode to
nothing).  The transitions' weights are learnable
(zero-initialised), one per arc of the transition graph, whose own weights
are set to 0.

The WFST convolution layer ``ConvTransduce1D`` (and ``make_kernel_graph``,
the host graph of one of its kernels) is here too, as in JAX: every
sliding window of its input scored against every lexicon entry's kernel
lattice by ``ops.convkernel``.
"""

import dataclasses
import math
import os
from multiprocessing.pool import ThreadPool
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import utils
from ..ops import convkernel, factored, sparse
from ..ops.semiring import NEG
from ..wfst import compile as wcompile
from ..wfst import native
from ..wfst import ops as wops
from ..wfst.graph import EPSILON, Graph, linear_graph
from .base import Criterion

# "on": the factored scorers wherever the gates and the dense packing take
# the batch, the loaded graph's backoff factorings included; "off" (alias
# "step"): always compose; "auto": ngram 1-2 and no transitions factored,
# a loaded graph composed (JAX factors it under auto only on the TPU)
_FACTORED_IMPL = os.environ.get("GTN_TRANSDUCER_FACTORED", "auto")
_FACTORED_DISABLED = ("off", "step")

# working-set gates of the dense packing (floats), as JAX's: [B, S, S]
# adjacency + [B, S, N] labels without transitions, the dense backoff
# variant's per-frame [B, S, N, S_c] contraction, the dst variant's
# [B, S, N + S_c] products
_DENSE_MAX_WORKSET = 48_000_000

# decode through the destination-factored scan once the epsilon-removed
# decode table would exceed this many arcs (S_c * N), as JAX does
_DECODE_FACTORED_MIN_ARCS = 1 << 15


# ---------------------------------------------------------------------------
# Graph builders (host; structure mirrors reference transducer.py:15-123)
# ---------------------------------------------------------------------------


def make_chain_graph(sequence) -> Graph:
    """Linear acceptor over a label sequence (transducer.py:23-29)."""
    return linear_graph([int(s) for s in sequence])


def make_transitions_graph(ngram, num_tokens) -> Graph:
    """Full n-gram token transition WFST (behavioral spec: reference
    transducer.py:32-58), every arc weight 0.

    Built as a context trie: one state per token history of length
    < ``ngram`` (breadth-first, so arc order matches the trie layer order),
    then full-order grams rotate the history window.  For ``ngram > 1`` a
    merged end state is reachable by an epsilon arc from every state.
    """
    g = Graph()
    root = g.add_node(True, ngram == 1)
    ctx_node = {(): root}
    frontier = [()]
    for _depth in range(ngram - 1):
        frontier = [ctx + (tok,) for ctx in frontier for tok in range(num_tokens)]
        for ctx in frontier:
            node = g.add_node(False, ngram == 1)
            ctx_node[ctx] = node
            g.add_arc(ctx_node[ctx[:-1]], node, ctx[-1])
    for ctx in frontier:
        for tok in range(num_tokens):
            g.add_arc(ctx_node[ctx], ctx_node[(ctx + (tok,))[1:]], tok)
    if ngram > 1:
        final = g.add_node(False, True)
        for node in range(final):
            g.add_arc(node, final, EPSILON)
    return g


def make_lexicon_graph(word_pieces, graphemes_to_idx) -> Graph:
    """Grapheme -> wordpiece transducer (behavioral spec: reference
    transducer.py:61-75): each piece spells out as a chain of grapheme
    inputs with epsilon outputs, the final grapheme emits the piece id and
    returns to the single hub (start/accept) state."""
    g = Graph()
    hub = g.add_node(True, True)
    for piece_id, piece in enumerate(word_pieces):
        spelled = [graphemes_to_idx[c] for c in piece]
        state = hub
        for ilabel in spelled[:-1]:
            nxt = g.add_node()
            g.add_arc(state, nxt, ilabel, EPSILON)
            state = nxt
        g.add_arc(state, hub, spelled[-1], piece_id)
    g.arc_sort()
    return g


def make_token_graph(token_list, blank="none", allow_repeats=True) -> Graph:
    """Alignment-label -> token transducer (behavioral spec: reference
    transducer.py:78-123): consuming one or more consecutive copies of an
    alignment label transduces to one token.  With a blank, an extra state
    consumes blank labels emitting nothing; 'forced' requires passing
    through it between tokens (token states are then non-accepting)."""
    if not allow_repeats and blank != "optional":
        raise ValueError("allow_repeats=False requires blank='optional'")
    n = len(token_list)
    g = Graph()
    hub = g.add_node(True, True)
    tok_state = [g.add_node(False, blank != "forced") for _ in range(n)]
    blank_state = None
    if blank != "none":
        # the blank emission channel is by convention the last one (id n)
        blank_state = g.add_node()
        g.add_arc(hub, blank_state, n, EPSILON)
        g.add_arc(blank_state, hub, EPSILON, EPSILON)
    entry = blank_state if blank == "forced" else hub
    for tok, state in enumerate(tok_state):
        g.add_arc(entry, state, tok, tok)
        g.add_arc(state, state, tok, EPSILON)  # absorb repeated emissions
        if not allow_repeats:
            g.add_arc(state, blank_state, n, EPSILON)
            for other in range(n):
                if other != tok:
                    g.add_arc(state, tok_state[other], other, other)
        elif blank == "forced":
            g.add_arc(state, blank_state, n, EPSILON)
        else:
            g.add_arc(state, hub, EPSILON, EPSILON)
    return g


# ---------------------------------------------------------------------------
# Criterion
# ---------------------------------------------------------------------------


class Transducer(Criterion):
    """Generic transducer loss (reference transducer.py:126-197).

    Args:
      tokens: list of iterables (e.g. strings / tuples) — output tokens.
      graphemes_to_idx: grapheme -> integer index of the emission channels
        consumed by target chains.
      ngram: order of a full n-gram transition model (0 = none).
      transitions: a pre-built transition Graph (e.g. a pruned backoff
        model from ``scripts.build_transitions``); exclusive with ngram.
      blank: 'none' | 'optional' | 'forced'.
      allow_repeats: allow consecutive identical tokens in alignments.
      reduction: 'none' or 'mean' (scale per-sample loss by 1/target_len).
    """

    def __init__(
        self,
        tokens,
        graphemes_to_idx,
        ngram=0,
        transitions=None,
        blank="none",
        allow_repeats=True,
        reduction="none",
    ):
        if blank not in ("optional", "forced", "none"):
            raise ValueError(
                f"blank={blank!r}: expected 'optional', 'forced', or 'none'"
            )
        if ngram > 0 and transitions is not None:
            raise ValueError("ngram and transitions are mutually exclusive")
        self.tokens = make_token_graph(tokens, blank=blank, allow_repeats=allow_repeats)
        self.lexicon = make_lexicon_graph(tokens, graphemes_to_idx)
        self.blank = blank
        self.reduction = reduction
        self._num_tokens = len(tokens)
        self.num_channels = len(tokens) + int(blank != "none")
        self.ngram = ngram
        if ngram > 0:
            transitions = make_transitions_graph(ngram, self.num_channels)
        self.transitions = None
        self.num_transition_arcs = 0
        if transitions is not None:
            # the arc weights are the learnable parameters (zero-initialised,
            # as in the reference); the graph's own weights are set to 0
            self.transitions = transitions.copy()
            self.transitions.set_weights([0.0] * transitions.num_arcs())
            self.num_transition_arcs = transitions.num_arcs()
            norm_cg = wcompile.compile_acceptor(self.transitions)
            self._norm_table = wcompile.to_arc_table(norm_cg)
            self._norm_widx = torch.from_numpy(norm_cg.arc_id.astype(np.int64))
            self._norm_eps_widx = torch.from_numpy(norm_cg.eps_arc_id.astype(np.int64))
            self._norm_on = {}
        # full n-gram models of order 1-2 factorize (ops/factored.py)
        self._factored_ngram = ngram if ngram in (1, 2) else 0
        # a loaded graph factorizes over a dense context axis: "dense"
        # ([N, S_c, S_c] matrices) or "dst" ([S_c, N], label-determined
        # advance destinations) where the gates allow
        self._factored_backoff = self._factored_backoff_dst = False
        self._dst_onehot = self._eps_lr_struct = None
        if self.transitions is not None and not self._factored_ngram:
            self._backoff_gates()
        self._factored_on = {}
        self._align_cache: Dict[tuple, tuple] = {}
        self._decode_template = None
        self._decode_cache = None
        self._decode_dst_cache = None
        # the decode table's structure for the kernels, by device (the
        # template's arcs never change; only their weights do), and the
        # normaliser's epsilon index likewise
        self._decode_plans = {}
        self._norm_indexes = {}

    def _backoff_gates(self):
        """``_factored_backoff`` (the dense [N, S_c, S_c] matrices fit) and
        ``_factored_backoff_dst`` (every label's non-self arcs share one
        destination, and [S_c, N] fits), with the latter's destination
        one-hot [N, S_c] and the low-rank structure of its epsilon closure
        (``factored.eps_chain_struct``, None where it does not pay)."""
        nt = self._norm_table
        S_c, N = nt.start.shape[0], self.num_channels
        labels = nt.label.numpy()
        real = nt.weight.numpy() > NEG / 2
        labels_ok = bool(nt.eps_depth <= 4 and (labels[real] < N).all()
                         and (labels[real] >= 0).all())
        self._factored_backoff = labels_ok and N * S_c * S_c <= 4_000_000
        if not (labels_ok and N * S_c <= 4_000_000):
            return
        src, dst = nt.src.numpy()[real], nt.dst.numpy()[real]
        adv = src != dst
        dst_of = {}
        for lab, d in zip(labels[real][adv].tolist(), dst[adv].tolist()):
            if dst_of.setdefault(lab, d) != d:
                return
        self._factored_backoff_dst = True
        p_dst = np.zeros((N, S_c), np.float32)
        p_dst[list(dst_of), list(dst_of.values())] = 1.0
        self._dst_onehot = p_dst
        self._eps_lr_struct = factored.eps_chain_struct(
            nt.eps_src.numpy(), nt.eps_dst.numpy(), S_c, nt.eps_depth)

    # -- parameters -----------------------------------------------------
    def init_params(self):
        if self.transitions is None:
            return {}
        return {"transitions": torch.zeros((self.num_transition_arcs,))}

    # -- host compilation ----------------------------------------------
    def _native_handles(self):
        """Persistent native handles of the lexicon, token and transition
        graphs, warmed so that the prepare thread pool can share them; None
        where the native library is not enabled."""
        if not native.enabled():
            return None
        if not hasattr(self, "_nh"):
            self._nh = (
                native.to_native(self.lexicon, warm=True),
                native.to_native(self.tokens, warm=True),
                native.to_native(self.transitions, warm=True)
                if self.transitions is not None else None,
            )
        return self._nh

    def _compile_target(self, target: tuple, compose_transitions=True):
        """(compiled lattice, widx, eps_widx) of one target (cached): with
        the transitions composed in, or the plain alignment lattice.  One
        native call where the library is enabled, else JAX's Python
        pipeline on ``wfst.ops``."""
        key = target if compose_transitions else (target, "plain")
        cached = self._align_cache.get(key)
        if cached is not None:
            return cached
        handles = self._native_handles()
        if handles is not None:
            lex, tok, trans = handles
            t = native.compile_alignment(
                lex, tok, trans if compose_transitions else None, target)
            cg = wcompile.CompiledGraph(
                src=t["src"], dst=t["dst"], label=t["label"], weight=t["weight"],
                arc_id=np.arange(len(t["src"]), dtype=np.int32),
                start=t["start"], accept=t["accept"],
                eps_src=t["eps_src"], eps_dst=t["eps_dst"],
                eps_weight=t["eps_weight"],
                eps_arc_id=np.arange(len(t["eps_src"]), dtype=np.int32),
                eps_depth=t["eps_depth"],
            )
            result = (cg, t["widx"], t["eps_widx"])
        else:
            result = self._compile_target_py(target, compose_transitions)
        if len(self._align_cache) > 100000:
            self._align_cache.clear()
        self._align_cache[key] = result
        return result

    def _compile_target_py(self, target, compose_transitions):
        """``_compile_target`` in Python: every wordpiece decomposition of
        the target (chain o lexicon, output side, epsilons removed), the
        token graph composed with it (input side) and, with transitions,
        composed under them; each compiled arc's transition arc (-1 for
        none) as its provenance ``widx`` / ``eps_widx``."""
        chain = make_chain_graph(target)
        tokens_target = wops.remove(wops.project_output(wops.compose(chain, self.lexicon)))
        alignments = wops.project_input(wops.remove(wops.compose(self.tokens, tokens_target)))
        if self.transitions is not None and compose_transitions:
            composed, prov = wops.compose(self.transitions, alignments, return_arc_map=True)
            cg = wcompile.compile_acceptor(composed)
            prov1 = np.asarray([p[0] for p in prov] + [-1], dtype=np.int32)
            return cg, prov1[cg.arc_id], prov1[cg.eps_arc_id]
        cg = wcompile.compile_acceptor(alignments)
        return (cg, -np.ones(len(cg.src), dtype=np.int32),
                -np.ones(len(cg.eps_src), dtype=np.int32))

    def _compile_all(self, keys, compose_transitions):
        """Compile the batch's targets, cache misses in parallel on a
        thread pool where the native pipeline runs (it releases the GIL)."""
        missing = [k for k in dict.fromkeys(keys)
                   if (k if compose_transitions else (k, "plain")) not in self._align_cache]
        if len(missing) > 1 and self._native_handles() is not None:
            with ThreadPool(min(8, len(missing))) as pool:
                pool.map(lambda k: self._compile_target(k, compose_transitions), missing)
        return [self._compile_target(k, compose_transitions) for k in keys]

    def prepare(self, targets):
        """Compile and pack per-sample lattices (host, cached): the dense
        tables of the factored path where ``_use_factored`` says so, else
        (or when the dense packing refuses the batch) the composed arc
        table."""
        keys = [tuple(int(t) for t in np.asarray(tgt).reshape(-1)) for tgt in targets]
        if self._use_factored():
            prepared = self._prepare_factored(keys)
            if prepared is not None:
                return prepared
        return self._prepare_composed(keys)

    def _use_factored(self):
        """JAX's routing (``GTN_TRANSDUCER_FACTORED``): off composes; ngram
        1-2 and no transitions factor otherwise; a loaded graph that a
        backoff gate admits factors under "on".  JAX also factors it under
        auto on the TPU, where segment ops are pathological; the card runs
        its segment ops through hand-written kernels, so the port's auto
        composes it on every device."""
        if _FACTORED_IMPL in _FACTORED_DISABLED:
            return False
        if self._factored_ngram or self.transitions is None:
            return True
        return _FACTORED_IMPL == "on" and (self._factored_backoff
                                           or self._factored_backoff_dst)

    def _prepare_composed(self, keys):
        """One arc table of the batch's composed lattices: on a union
        skeleton where one exists, else stacked per sample, with the
        provenance of each arc's learnable weight (-1 for none)."""
        compiled = self._compile_all(keys, compose_transitions=True)
        cgs = [c[0] for c in compiled]
        union = wcompile.union_stack_arc_tables(cgs)
        if union is not None:
            table, positions, eps_positions = union
            A, E = table.src.shape[0], table.eps_src.shape[0]
            widx = -np.ones((len(cgs), A), np.int64)
            eps_widx = -np.ones((len(cgs), max(E, 1)), np.int64)
            for b, c in enumerate(compiled):
                widx[b, positions[b]] = c[1]
                if E and len(eps_positions[b]):
                    eps_widx[b, eps_positions[b]] = c[2]
        else:
            table = wcompile.stack_arc_tables(cgs)
            A, E = table.src.shape[1], table.eps_src.shape[1]
            widx = np.stack([np.concatenate([c[1], -np.ones(A - len(c[1]), np.int32)])
                             for c in compiled]).astype(np.int64)
            eps_widx = np.stack([np.concatenate([c[2], -np.ones(E - len(c[2]), np.int32)])
                                 for c in compiled]).astype(np.int64)
        return {
            "table": table,
            "widx": torch.from_numpy(widx),
            "eps_widx": torch.from_numpy(eps_widx),
            "target_lengths": torch.from_numpy(
                np.asarray([len(k) for k in keys], dtype=np.int32)),
        }

    def _prepare_factored(self, keys):
        """Plain alignment lattices as dense adjacency + in-label tables,
        or None if a sample's lattice has epsilon arcs, a state with mixed
        in-labels, arc weights too large for the exp-space adjacency, or
        the batch exceeds the working-set gate.  A loaded graph takes the
        dense variant where its gate and working set allow, else the dst
        variant (marked ``"factored_dst"``) where they allow."""
        cgs = [c[0] for c in self._compile_all(keys, compose_transitions=False)]

        N = self.num_channels
        # states rounded up to a multiple of 8, so width-sorted batches see
        # few shapes; at least one bucket, so a batch of empty lattices
        # (untransducible targets) scores NEG
        S = -(-max([len(cg.start) for cg in cgs] + [1]) // 8) * 8
        B = len(cgs)
        variant = None
        if self.transitions is None:
            if B * S * (S + N) > _DENSE_MAX_WORKSET:
                return None
        elif not self._factored_ngram:
            S_c = self._norm_table.start.shape[0]
            if self._factored_backoff and B * S * N * S_c <= _DENSE_MAX_WORKSET:
                variant = "dense"
            elif self._factored_backoff_dst and B * S * (N + S_c) <= _DENSE_MAX_WORKSET:
                variant = "dst"
            else:
                return None
        adj_exp = np.zeros((B, S, S), np.float32)
        lab_oh = np.zeros((B, S, N), np.float32)
        start = np.full((B, S), NEG, np.float32)
        accept = np.full((B, S), NEG, np.float32)
        for b, cg in enumerate(cgs):
            if cg.eps_depth != 0 or len(cg.eps_src) > 0:
                return None
            real = cg.weight > NEG / 2
            src, dst = cg.src[real], cg.dst[real]
            lab, w = cg.label[real], cg.weight[real]
            if w.size and (np.abs(w).max() > 30.0 or lab.max() >= N):
                return None
            # unique in-label per state
            lo = np.full((len(cg.start),), 2**31, np.int64)
            np.minimum.at(lo, dst, lab.astype(np.int64))
            hi = np.full((len(cg.start),), -1, np.int64)
            np.maximum.at(hi, dst, lab.astype(np.int64))
            entered = hi >= 0
            if np.any(lo[entered] != hi[entered]):
                return None
            np.add.at(adj_exp[b], (dst, src), np.exp(w))
            states = np.nonzero(entered)[0]
            lab_oh[b, states, hi[states]] = 1.0
            start[b, : len(cg.start)] = cg.start
            accept[b, : len(cg.accept)] = cg.accept
        lengths = np.asarray([len(k) for k in keys], dtype=np.int32)
        prepared = {
            "factored": {
                "adj_exp": torch.from_numpy(adj_exp),
                "lab_oh": torch.from_numpy(lab_oh),
                "start": torch.from_numpy(start),
                "accept": torch.from_numpy(accept),
            },
            "target_lengths": torch.from_numpy(lengths),
        }
        if variant == "dst":
            prepared["factored_dst"] = ()
        return prepared

    # -- loss -----------------------------------------------------------
    @staticmethod
    def _apply_params(table, widx, eps_widx, params):
        """``table`` with the learnable weights added: weight + params[widx]
        (nothing where widx is -1), likewise for the epsilon arcs."""
        w_ext = torch.cat([params, params.new_zeros(1)])
        n = params.shape[0]
        weight = table.weight + w_ext[torch.where(widx >= 0, widx, n)]
        eps_weight = table.eps_weight + w_ext[torch.where(eps_widx >= 0, eps_widx, n)]
        return dataclasses.replace(table, weight=weight, eps_weight=eps_weight)

    def _norm_table_on(self, device):
        """The transition graph's own table and provenance on ``device``."""
        if device not in self._norm_on:
            self._norm_on[device] = (
                self._norm_table.to(device),
                self._norm_widx.to(device), self._norm_eps_widx.to(device))
        return self._norm_on[device]

    def _eff_weights(self, params):
        """The transition graph's effective arc and epsilon weights (its
        static weights plus the learnable ``params``), on ``params``'
        device: the one place the factored matrices and the low-rank
        closure read them from (the composed normaliser's
        ``_apply_params``)."""
        table = self._apply_params(*self._norm_table_on(params.device), params)
        return table.weight, table.eps_weight

    def _factored_tables(self, device):
        """The transition graph's static index arrays for the factored
        matrices, the destination one-hot and the low-rank closure's
        structure, on ``device`` (built once a device)."""
        if device not in self._factored_on:
            nt, _, _ = self._norm_table_on(device)
            tabs = {"label": nt.label.long().clamp(0, self.num_channels - 1),
                    "src": nt.src.long(), "dst": nt.dst.long(),
                    "eps_src": nt.eps_src.long(), "eps_dst": nt.eps_dst.long()}
            tabs["is_self"] = tabs["src"] == tabs["dst"]
            if self._dst_onehot is not None:
                tabs["p_dst"] = torch.from_numpy(self._dst_onehot).to(device)
            if self._eps_lr_struct is not None:
                tabs["eps_lr"] = tuple(torch.from_numpy(a).to(device)
                                       for a in self._eps_lr_struct)
            self._factored_on[device] = tabs
        return self._factored_on[device]

    def _eps_matrix(self, ew_eff, tabs, S_c):
        """(E_exp [S_c, S_c], e_shift): the epsilon arcs' exp-weights under
        a gradient-free shift, so learned weights cannot overflow."""
        if not ew_eff.shape[0]:
            return ew_eff.new_zeros((S_c, S_c)), ew_eff.new_zeros(())
        e_shift = torch.clamp(torch.amax(ew_eff), min=0.0).detach()
        E_exp = ew_eff.new_zeros((S_c, S_c)).index_put(
            (tabs["eps_src"], tabs["eps_dst"]), torch.exp(ew_eff - e_shift),
            accumulate=True)
        return E_exp, e_shift

    def _transition_matrices(self, w_eff, ew_eff):
        """The dense variant's per-label exp-matrices: (start, accept,
        T_exp [N, S_c, S_c], t_shift, E_exp, e_shift, depth).  Padding arcs
        (weight NEG) underflow to an exact 0."""
        nt, _, _ = self._norm_table_on(w_eff.device)
        tabs = self._factored_tables(w_eff.device)
        S_c, N = nt.start.shape[0], self.num_channels
        t_shift = torch.clamp(torch.amax(w_eff), min=0.0).detach()
        T_exp = w_eff.new_zeros((N, S_c, S_c)).index_put(
            (tabs["label"], tabs["src"], tabs["dst"]), torch.exp(w_eff - t_shift),
            accumulate=True)
        return (nt.start, nt.accept, T_exp, t_shift,
                *self._eps_matrix(ew_eff, tabs, S_c), nt.eps_depth)

    def _transition_matrices_dst(self, w_eff, ew_eff):
        """The dst variant's [S_c, N]-sized matrices: (start, accept,
        W_adv_exp [S_c, N] of the advance arcs, D_exp_t [N, S_c] of the
        self-loops, P_dst [N, S_c], t_shift, E_exp, e_shift, depth)."""
        nt, _, _ = self._norm_table_on(w_eff.device)
        tabs = self._factored_tables(w_eff.device)
        S_c, N = nt.start.shape[0], self.num_channels
        t_shift = torch.clamp(torch.amax(w_eff), min=0.0).detach()
        exp_w = torch.exp(w_eff - t_shift)
        W_adv_exp = w_eff.new_zeros((S_c, N)).index_put(
            (tabs["src"], tabs["label"]), torch.where(tabs["is_self"], 0.0, exp_w),
            accumulate=True)
        D_exp_t = w_eff.new_zeros((N, S_c)).index_put(
            (tabs["label"], tabs["src"]), torch.where(tabs["is_self"], exp_w, 0.0),
            accumulate=True)
        return (nt.start, nt.accept, W_adv_exp, D_exp_t, tabs["p_dst"], t_shift,
                *self._eps_matrix(ew_eff, tabs, S_c), nt.eps_depth)

    def _backoff_factored_loss(self, p, inputs, prepared, input_lengths):
        """Per-sample losses of a loaded graph through its backoff
        factorings: the dense variant, or the dst variant (its low-rank
        closure on the exp tier, where the structure pays)."""
        f = prepared["factored"]
        lattice = (inputs, f["adj_exp"], f["lab_oh"], f["start"], f["accept"])
        w_eff, ew_eff = self._eff_weights(p)
        if "factored_dst" not in prepared and self._factored_backoff:
            tmats = self._transition_matrices(w_eff, ew_eff)
            score = factored.backoff_factored_score(*lattice, *tmats, input_lengths)
            norm = factored.backoff_dense_norm(inputs, *tmats, input_lengths)
            return -(score - norm)
        tmats = self._transition_matrices_dst(w_eff, ew_eff)
        elr = None
        if self._eps_lr_struct is not None and factored._use_vjp():
            elr = factored.eps_lowrank_build(
                ew_eff, self._factored_tables(p.device)["eps_lr"])
        score = factored.backoff_dst_factored_score(*lattice, *tmats, input_lengths,
                                                    eps_lowrank=elr)
        norm = factored.backoff_dst_norm(inputs, *tmats, input_lengths, eps_lowrank=elr)
        return -(score - norm)

    def loss(self, params, inputs, prepared, input_lengths=None):
        """inputs: [B, T, N] logits, blank (if any) at the last channel."""
        if "table" in prepared:
            table = prepared["table"]
            if self.transitions is None:
                # log_softmax normalises each frame; the lattice score is the loss
                em = torch.log_softmax(inputs, dim=2)
                score = sparse.forward_score_batch_tables(em, table, input_lengths)
                return self._reduce(-score, prepared)
            p = params["transitions"]
            table = self._apply_params(table, prepared["widx"], prepared["eps_widx"], p)
            score = sparse.forward_score_batch_tables(inputs, table, input_lengths)
            norm_table = self._apply_params(*self._norm_table_on(inputs.device), p)
            norm = sparse.forward_score_batch(inputs, norm_table, input_lengths,
                                              self._norm_indexes)
            return self._reduce(-(score - norm), prepared)
        f = prepared["factored"]
        if self.transitions is None:
            # log_softmax normalises each frame; the lattice score is the loss
            em = torch.log_softmax(inputs, dim=2)
            score = factored.alignment_lattice_score(
                em, f["adj_exp"], f["lab_oh"], f["start"], f["accept"],
                input_lengths,
            )
            return self._reduce(-score, prepared)
        if not self._factored_ngram:
            return self._reduce(self._backoff_factored_loss(
                params["transitions"], inputs, prepared, input_lengths), prepared)
        ws, W, we, we0 = factored.ngram_rows(
            params["transitions"], self.ngram, self.num_channels
        )
        score = factored.factored_lattice_score(
            inputs, f["adj_exp"], f["lab_oh"], f["start"], f["accept"],
            ws, W, we, input_lengths, we0,
        )
        norm = factored.dense_ngram_norm(inputs, ws, W, we, input_lengths, we0)
        return self._reduce(-(score - norm), prepared)

    def _reduce(self, losses, prepared):
        if self.reduction == "mean":
            lens = prepared["target_lengths"].to(losses.device)
            losses = losses * torch.where(
                lens > 0, 1.0 / torch.clamp(lens, min=1), 1.0)
        elif self.reduction != "none":
            raise ValueError(f"invalid reduction {self.reduction}")
        return torch.mean(losses)

    # -- decoding -------------------------------------------------------
    def _decode_table(self, params):
        """The tropical decode table of the transition graph under the
        current weights.  Re-weighted from a structural template whenever
        the parameter tensor changes: an optimizer updates it in place,
        so the cache is keyed by the tensor, its version counter and its
        storage, not by its identity alone."""
        ptr = params["transitions"]
        key = (ptr._version, ptr.data_ptr())
        cached = self._decode_cache
        if cached is not None and cached[0] is ptr and cached[1] == key:
            return cached[2]
        if self._decode_template is None:
            self._decode_template = wcompile.build_decode_template(self.transitions)
        table = wcompile.apply_decode_weights(
            self._decode_template, utils.to_host(ptr.detach()).numpy())
        self._decode_cache = (ptr, key, table)
        return table

    def _decode_matrices_dst(self, params, device):
        """The tropical [S_c, N] matrices of ``factored.backoff_dst_viterbi``
        under the current weights, on ``device``: (start, accept, W_adv_log,
        D_log, dst one-hot, E_log, depth), parallel arcs max-merged, NEG
        where there is no arc.  Cached like ``_decode_table``."""
        ptr = params["transitions"]
        key = (ptr._version, ptr.data_ptr(), device)
        cached = self._decode_dst_cache
        if cached is not None and cached[0] is ptr and cached[1] == key:
            return cached[2]
        nt = self._norm_table
        S_c, N = nt.start.shape[0], self.num_channels
        w_eff, ew_eff = (w.numpy() for w in self._eff_weights(utils.to_host(ptr.detach())))
        src, dst = nt.src.numpy(), nt.dst.numpy()
        lab = np.clip(nt.label.numpy(), 0, N - 1)
        real = nt.weight.numpy() > NEG / 2
        is_self, is_adv = (src == dst) & real, (src != dst) & real
        W_adv = np.full((S_c, N), NEG, np.float32)
        np.maximum.at(W_adv, (src[is_adv], lab[is_adv]), w_eff[is_adv])
        D = np.full((S_c, N), NEG, np.float32)
        np.maximum.at(D, (src[is_self], lab[is_self]), w_eff[is_self])
        E = np.full((S_c, S_c), NEG, np.float32)
        np.maximum.at(E, (nt.eps_src.numpy(), nt.eps_dst.numpy()), ew_eff)
        mats = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                     for a in (nt.start, nt.accept, W_adv, D, self._dst_onehot, E))
        mats = mats + (nt.eps_depth,)
        self._decode_dst_cache = (ptr, key, mats)
        return mats

    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        outputs = outputs.detach()
        if self.transitions is not None:
            params = params if params is not None else self.params
            if (self._factored_backoff_dst and self._norm_table.start.shape[0]
                    * self.num_channels > _DECODE_FACTORED_MIN_ARCS):
                # the epsilon-removed table would hold ~S_c * N arcs: decode
                # through the destination-factored tropical scan instead
                labels, _ = factored.backoff_dst_viterbi(
                    outputs, *self._decode_matrices_dst(params, outputs.device),
                    input_lengths)
                return (labels, input_lengths)
            labels, _ = sparse.viterbi_batch(
                outputs, self._decode_table(params), input_lengths, self._decode_plans)
        else:
            labels = torch.argmax(outputs, dim=2)
        return (labels, input_lengths)

    def viterbi_finalize(self, handle):
        labels, input_lengths = handle
        if input_lengths is not None:
            input_lengths = utils.to_host(torch.as_tensor(input_lengths)).numpy()
        return self._transduce(utils.to_host(labels).numpy(), input_lengths)

    def viterbi(self, outputs, params=None, input_lengths=None):
        """Best alignment path through the emissions (and the transitions),
        transduced to tokens taking the shortest ambiguous output
        (reference transducer.py:199-234)."""
        return self.viterbi_finalize(
            self.viterbi_dispatch(outputs, params, input_lengths)
        )

    def _transduce(self, labels, input_lengths):
        """For blank none / optional the token graph's shortest
        transduction is run-collapse-then-drop-blank; -1 labels occur only
        on dead frames, which the length mask removes.  For 'forced' the
        native ``forced_collapse`` also checks the alignment against the
        forced token graph; where the library is not enabled, each path
        goes through the token graph in Python (``_alignment_to_tokens``)."""
        if self.blank == "forced":
            if native.enabled():
                return native.forced_collapse(labels, self._num_tokens, input_lengths)
            lens = None if input_lengths is None else np.asarray(input_lengths)
            out = []
            for b in range(labels.shape[0]):
                seq = [int(l) for l in labels[b] if l >= 0]
                if lens is not None:
                    seq = seq[: int(lens[b])]
                out.append(np.asarray(self._alignment_to_tokens(seq), dtype=np.int32))
            return out
        Bn, Tn = labels.shape
        keep = np.ones((Bn, Tn), dtype=bool)
        keep[:, 1:] = labels[:, 1:] != labels[:, :-1]
        keep &= (labels >= 0) & (labels < self._num_tokens)
        if input_lengths is not None:
            keep &= np.arange(Tn)[None, :] < np.asarray(input_lengths)[:, None]
        return [labels[b, keep[b]].astype(np.int32) for b in range(Bn)]

    def _alignment_to_tokens(self, seq):
        """The tokens of one alignment label sequence by the forced token
        graph, the shortest output on ties (reference transducer.py:224-229):
        the path composed with the tokens, each non-epsilon output
        penalised by 1e-6, the best path's output side, epsilons removed;
        nothing where the graph does not accept the path."""
        composed = wops.compose(make_chain_graph(seq), self.tokens)
        for i in range(composed.num_arcs()):
            if composed.arc_olabel[i] != EPSILON:
                composed.arc_weight[i] -= 1e-6
        best = wops.viterbi_path(composed)
        return wops.remove(wops.project_output(best)).labels_to_list()


# ---------------------------------------------------------------------------
# WFST convolution layer
# ---------------------------------------------------------------------------


def make_kernel_graph(x, blank_idx, blank_optional, spike=False):
    """Host Graph of a conv-transduce kernel; for tests and debugging, the
    layer itself runs on compiled banded tables
    (``ops.convkernel.compile_kernels``).

    Per token: a 'token' state (self-loop unless spike) and a 'post-blank'
    state; accept at the last pair (the token state only when blank is
    optional).  With optional blank, distinct adjacent tokens connect
    directly, skipping the blank."""
    g = Graph()
    entry = g.add_node(True, len(x) == 0)
    g.add_arc(entry, entry, blank_idx)
    prev_tok_state = None
    prev_label = None
    for pos, label in enumerate(x):
        last = pos + 1 == len(x)
        tok_state = g.add_node(False, blank_optional and last)
        gap_state = g.add_node(False, last)
        g.add_arc(entry, tok_state, label)
        if not spike:
            g.add_arc(tok_state, tok_state, label)
        g.add_arc(tok_state, gap_state, blank_idx)
        g.add_arc(gap_state, gap_state, blank_idx)
        if blank_optional and prev_tok_state is not None and prev_label != label:
            g.add_arc(prev_tok_state, tok_state, label)
        prev_tok_state, prev_label = tok_state, label
        entry = gap_state
    return g


class ConvTransduce1D(nn.Module):
    """1-D convolutional transducer layer: each output channel is the
    forward (or Viterbi) score of a small kernel WFST over a sliding
    ``kernel_size`` window of the input, [B, T, C] -> [B, W, V] with
    W = (T - 1) // stride + 1 and V lexicon entries.

    All kernel lattices of all windows are scored in one batched banded
    recursion (``ops.convkernel``).  With ``learn_params`` the kernels' arc
    weights are the parameter ``kernel_params``, zero at the start; as in
    JAX, where they sit in the model's parameters, they take the model's
    learning rate and gradient clipping.  ``normalize="pre"`` pads the
    input and log-softmaxes it before windowing and exponentiates the
    scores, ``"post"`` softmaxes the scores over V; ``scale`` divides them
    by 1, sqrt(K) or K."""

    def __init__(self, lexicon, kernel_size, stride, blank_idx,
                 blank_optional=True, learn_params=False, scale="none",
                 normalize="none", viterbi=False, spike=False):
        super().__init__()
        self.normalize = normalize
        self.viterbi = viterbi
        if scale == "none":
            self.scale = 1.0
        elif scale == "sqrt":
            self.scale = math.sqrt(kernel_size)
        elif scale == "linear":
            self.scale = float(kernel_size)
        else:
            raise ValueError(f"Unknown scale {scale}")
        if normalize not in ["none", "pre", "post"]:
            raise ValueError(f"Unknown normalization {normalize}")
        if kernel_size % 2 == 0:
            raise ValueError("Use an odd kernel size for easy padding.")

        def size_with_rep(token):
            reps = sum(t1 == t2 for t1, t2 in zip(token[:-1], token[1:]))
            return len(token) + reps

        min_kernel_size = max(size_with_rep(l) for l in lexicon)
        if kernel_size < min_kernel_size:
            raise ValueError(f"Kernel size needed of at least {min_kernel_size}.")
        self.kernel_size = kernel_size
        self.stride = stride
        self.learn_params = learn_params
        tables = convkernel.compile_kernels(lexicon, blank_idx, blank_optional, spike)
        self.num_params = tables.num_params
        # the tables follow the module's device; they are rebuilt from the
        # lexicon, so no checkpoint holds them
        for name, value in convkernel.tables_on(tables, "cpu")._asdict().items():
            if name != "num_params":
                self.register_buffer(f"tables_{name}", value, persistent=False)
        self.kernel_params = (
            nn.Parameter(torch.zeros(tables.num_params)) if learn_params else None
        )

    @property
    def tables(self):
        return convkernel.KernelTables(
            **{n: getattr(self, f"tables_{n}") for n in convkernel._FIELDS},
            num_params=self.num_params,
        )

    def forward(self, inputs):
        # pad the raw scores first so that with normalize='pre' the padded
        # edge frames normalize to uniform log-probs (-log C), not 0
        pad = self.kernel_size // 2
        inputs = torch.nn.functional.pad(inputs, (0, 0, pad, pad))
        if self.normalize == "pre":
            inputs = torch.log_softmax(inputs, dim=2)
        windows = convkernel.make_windows(
            inputs, self.kernel_size, self.stride, padded=True
        )
        outputs = convkernel.conv_transduce_scores(
            windows, self.tables, self.kernel_params, self.viterbi
        )
        outputs = outputs / self.scale
        if self.normalize == "post":
            outputs = torch.softmax(outputs, dim=2)
        if self.normalize == "pre":
            outputs = torch.exp(outputs)
        return outputs
