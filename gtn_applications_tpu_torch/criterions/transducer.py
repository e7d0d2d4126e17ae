"""Generic WFST transducer criterion (PyTorch), full n-gram and
transitions-free variants.

Counterpart of ``gtn_applications_tpu/criterions/transducer.py``: the
reference composes, per sample, the target chain with a lexicon (wordpiece
decompositions), then with a token graph (alignments over emission labels)
and optionally with a transition model, and scores the result against the
emissions.  Here the per-target pipeline runs once per distinct target in
the native graph compiler (``wfst.native.compile_alignment``), cached, and
the alignment lattice is packed into dense tables (adjacency, in-labels,
start, accept) that the device recursions score:

  * ``ngram`` 1 or 2: the transition weight between two alignment arcs
    depends only on their labels, so the lattice is scored under a bigram
    factor (``ops.factored.factored_lattice_score``, whose
    ``factored_scan`` runs on the card's kernels) and normalised by the
    dense n-gram lattice alone (``dense_ngram_norm``);
  * no transitions: the log-softmaxed emissions through the plain
    alignment lattice (``alignment_lattice_score`` and ``dense_scan``).

The JAX package gates the transitions-free dense variant on the TPU; the
port always takes it.  Decoding with transitions goes through a decode
template of the transition graph (``wfst.compile``) and the whole-scan
Viterbi (``ops.sparse.viterbi_batch``); without, it is an argmax.  The
transitions' weights are learnable (zero-initialised), one per arc of
``make_transitions_graph``.

Not ported yet, each raising ``NotImplementedError``: a loaded
``transitions`` graph and the backoff variants (ROADMAP queue A items 7
and 8), ``ngram`` > 2 and batches the dense packing refuses (the composed
sparse path, A.7), ``blank="forced"`` decoding (native ``forced_collapse``,
A.7).  The ``ConvTransduce1D`` layer is A.9.
"""

from multiprocessing.pool import ThreadPool
from typing import Dict

import numpy as np
import torch

from ..ops import factored, sparse
from ..ops.semiring import NEG
from ..wfst import compile as wcompile
from ..wfst import native
from ..wfst.graph import EPSILON, Graph, linear_graph
from .base import Criterion

# [B, S, S] adjacency + [B, S, N] label working-set gate (floats), as JAX's
_DENSE_MAX_WORKSET = 48_000_000


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
      ngram: order of a full n-gram transition model: 0 (none), 1 or 2.
      transitions: a pre-built transition Graph; not ported yet (raises).
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
        if transitions is not None:
            raise NotImplementedError(
                "a loaded transitions graph (the backoff variants and the "
                "composed path) is not ported yet (ROADMAP queue A items 7 "
                "and 8)"
            )
        if ngram > 2:
            raise NotImplementedError(
                f"ngram={ngram} needs the composed sparse path, which is not "
                "ported yet (ROADMAP queue A item 7)"
            )
        self.tokens = make_token_graph(tokens, blank=blank, allow_repeats=allow_repeats)
        self.lexicon = make_lexicon_graph(tokens, graphemes_to_idx)
        self.blank = blank
        self.reduction = reduction
        self._num_tokens = len(tokens)
        self.num_channels = len(tokens) + int(blank != "none")
        self.ngram = ngram
        self.transitions = None
        self.num_transition_arcs = 0
        if ngram > 0:
            # the arc weights are the learnable parameters (zero-initialised,
            # as in the reference); the graph's own weights stay 0
            self.transitions = make_transitions_graph(ngram, self.num_channels)
            self.num_transition_arcs = self.transitions.num_arcs()
        self._align_cache: Dict[tuple, wcompile.CompiledGraph] = {}
        self._decode_template = None
        self._decode_cache = None

    # -- parameters -----------------------------------------------------
    def init_params(self):
        if self.transitions is None:
            return {}
        return {"transitions": torch.zeros((self.num_transition_arcs,))}

    # -- host compilation ----------------------------------------------
    def _native_handles(self):
        """Persistent native handles of the lexicon and token graphs,
        warmed so that the prepare thread pool can share them."""
        if not hasattr(self, "_nh"):
            self._nh = (
                native.to_native(self.lexicon, warm=True),
                native.to_native(self.tokens, warm=True),
            )
        return self._nh

    def _compile_target(self, target: tuple):
        """The plain alignment lattice of one target (cached)."""
        cached = self._align_cache.get(target)
        if cached is not None:
            return cached
        lex, tok = self._native_handles()
        t = native.compile_alignment(lex, tok, None, target)
        cg = wcompile.CompiledGraph(
            src=t["src"], dst=t["dst"], label=t["label"], weight=t["weight"],
            arc_id=np.arange(len(t["src"]), dtype=np.int32),
            start=t["start"], accept=t["accept"],
            eps_src=t["eps_src"], eps_dst=t["eps_dst"],
            eps_weight=t["eps_weight"],
            eps_arc_id=np.arange(len(t["eps_src"]), dtype=np.int32),
            eps_depth=t["eps_depth"],
        )
        if len(self._align_cache) > 100000:
            self._align_cache.clear()
        self._align_cache[target] = cg
        return cg

    def prepare(self, targets):
        """Compile and pack per-sample alignment lattices (host, cached).

        Cache misses compile in parallel on a thread pool (the native
        pipeline releases the GIL)."""
        keys = [tuple(int(t) for t in np.asarray(tgt).reshape(-1)) for tgt in targets]
        prepared = self._prepare_factored(keys)
        if prepared is None:
            raise NotImplementedError(
                "Transducer batch refused by the dense packing (epsilon arcs, "
                "mixed in-labels, large arc weights or the working-set gate): "
                "the composed sparse path is not ported yet (ROADMAP queue A "
                "item 7)"
            )
        return prepared

    def _prepare_factored(self, keys):
        """Plain alignment lattices as dense adjacency + in-label tables,
        or None if a sample's lattice has epsilon arcs, a state with mixed
        in-labels, arc weights too large for the exp-space adjacency, or
        the batch exceeds the working-set gate."""
        missing = [k for k in dict.fromkeys(keys) if k not in self._align_cache]
        if len(missing) > 1:
            self._native_handles()
            with ThreadPool(min(8, len(missing))) as pool:
                pool.map(self._compile_target, missing)
        cgs = [self._compile_target(k) for k in keys]

        N = self.num_channels
        # states rounded up to a multiple of 8, so width-sorted batches see
        # few shapes; at least one bucket, so a batch of empty lattices
        # (untransducible targets) scores NEG
        S = -(-max([len(cg.start) for cg in cgs] + [1]) // 8) * 8
        B = len(cgs)
        if self.transitions is None and B * S * (S + N) > _DENSE_MAX_WORKSET:
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
        return {
            "factored": {
                "adj_exp": torch.from_numpy(adj_exp),
                "lab_oh": torch.from_numpy(lab_oh),
                "start": torch.from_numpy(start),
                "accept": torch.from_numpy(accept),
            },
            "target_lengths": torch.from_numpy(lengths),
        }

    # -- loss -----------------------------------------------------------
    def loss(self, params, inputs, prepared, input_lengths=None):
        """inputs: [B, T, N] logits, blank (if any) at the last channel."""
        f = prepared["factored"]
        if self.transitions is None:
            # log_softmax normalises each frame; the lattice score is the loss
            em = torch.log_softmax(inputs, dim=2)
            score = factored.alignment_lattice_score(
                em, f["adj_exp"], f["lab_oh"], f["start"], f["accept"],
                input_lengths,
            )
            return self._reduce(-score, prepared)
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
            self._decode_template, ptr.detach().cpu().numpy())
        self._decode_cache = (ptr, key, table)
        return table

    def viterbi_dispatch(self, outputs, params=None, input_lengths=None):
        if self.blank == "forced":
            raise NotImplementedError(
                "blank='forced' decoding needs the native forced_collapse, "
                "which is not ported yet (ROADMAP queue A item 7)"
            )
        outputs = outputs.detach()
        if self.transitions is not None:
            params = params if params is not None else self.params
            labels, _ = sparse.viterbi_batch(
                outputs, self._decode_table(params), input_lengths)
        else:
            labels = torch.argmax(outputs, dim=2)
        return (labels, input_lengths)

    def viterbi_finalize(self, handle):
        labels, input_lengths = handle
        if input_lengths is not None:
            input_lengths = torch.as_tensor(input_lengths).cpu().numpy()
        return self._transduce(labels.cpu().numpy(), input_lengths)

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
        on dead frames, which the length mask removes."""
        Bn, Tn = labels.shape
        keep = np.ones((Bn, Tn), dtype=bool)
        keep[:, 1:] = labels[:, 1:] != labels[:, :-1]
        keep &= (labels >= 0) & (labels < self._num_tokens)
        if input_lengths is not None:
            keep &= np.arange(Tn)[None, :] < np.asarray(input_lengths)[:, None]
        return [labels[b, keep[b]].astype(np.int32) for b in range(Bn)]
