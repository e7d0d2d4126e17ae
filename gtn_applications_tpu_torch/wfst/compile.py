"""Compile host Graphs into fixed-shape numpy arc tables.

Counterpart of ``CompiledGraph``, ``_eps_depth``, ``compile_acceptor``,
the decode template (``DecodeTemplate``, ``build_decode_template``,
``apply_decode_weights``) and ``to_arc_table`` of
``gtn_applications_tpu/wfst/compile.py``: an acceptor Graph becomes numpy
arrays (emitting arcs, epsilon arcs with their closure depth, start and
accept potentials), and a transition graph with learnable arc weights
becomes an epsilon-free tropical decode ``ArcTable`` re-weighted per
parameter update in O(nnz) numpy; a batch of compiled graphs becomes one
table of the sparse scorer, on a shared union skeleton
(``union_stack_arc_tables``) or stacked per sample (``stack_arc_tables``),
both with JAX's shape bucketing.  ``compile_acceptor(remove_eps=True)``
removes epsilons through ``wfst.ops.remove``: the native graph compiler
where it is enabled, else the Python operation, as JAX's does.
"""

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.semiring import NEG
from ..ops.sparse import ArcTable
from . import ops as gops
from .graph import EPSILON, Graph


class CompiledGraph(NamedTuple):
    """Numpy arc tables for one acceptor, before padding/stacking."""

    src: np.ndarray
    dst: np.ndarray
    label: np.ndarray
    weight: np.ndarray
    arc_id: np.ndarray        # original Graph arc index per emitting arc
    start: np.ndarray
    accept: np.ndarray
    eps_src: np.ndarray
    eps_dst: np.ndarray
    eps_weight: np.ndarray
    eps_arc_id: np.ndarray    # original Graph arc index per epsilon arc
    eps_depth: int


def _eps_depth(g: Graph) -> int:
    """Longest epsilon chain (raises on epsilon cycles)."""
    eps_out = {}
    for i in range(g.num_arcs()):
        if g.arc_ilabel[i] == EPSILON and g.arc_olabel[i] == EPSILON:
            eps_out.setdefault(g.arc_src[i], []).append(g.arc_dst[i])
    depth = {}

    def dfs(s, onpath):
        if s in depth:
            return depth[s]
        best = 0
        for d in eps_out.get(s, ()):
            if d in onpath:
                raise ValueError("epsilon cycle")
            best = max(best, 1 + dfs(d, onpath | {s}))
        depth[s] = best
        return best

    return max((dfs(s, frozenset()) for s in range(g.num_nodes())), default=0)


def compile_acceptor(g: Graph, semiring: str = "log",
                     remove_eps: bool = False) -> CompiledGraph:
    """Compile an acceptor Graph to arc tables.

    Args:
      semiring: 'log' combines parallel final weights of a node with
        logsumexp, 'tropical' with max (Viterbi decode tables).
      remove_eps: fold the epsilon arcs away first (``wfst.ops.remove``),
        as a Viterbi table needs.
    """
    if remove_eps:
        g = gops.remove(g)

    S = g.num_nodes()
    src, dst, label, weight, arc_id = [], [], [], [], []
    esrc, edst, eweight, earc_id = [], [], [], []
    for i in range(g.num_arcs()):
        il, ol = g.arc_ilabel[i], g.arc_olabel[i]
        if il == EPSILON and ol == EPSILON:
            esrc.append(g.arc_src[i])
            edst.append(g.arc_dst[i])
            eweight.append(g.arc_weight[i])
            earc_id.append(i)
        else:
            if il == EPSILON or ol == EPSILON:
                raise ValueError(
                    "compile_acceptor requires an acceptor (project first)"
                )
            src.append(g.arc_src[i])
            dst.append(g.arc_dst[i])
            label.append(il)
            weight.append(g.arc_weight[i])
            arc_id.append(i)

    start = np.full((S,), NEG, dtype=np.float32)
    for s in g.start_nodes():
        start[s] = 0.0
    accept = np.full((S,), NEG, dtype=np.float32)
    for s, ws in g.finals.items():
        ws = np.asarray(ws, dtype=np.float64)
        if semiring == "log":
            m = ws.max()
            accept[s] = m + np.log(np.exp(ws - m).sum())
        elif semiring == "tropical":
            accept[s] = ws.max()
        else:
            raise ValueError(f"unknown semiring {semiring}")

    return CompiledGraph(
        src=np.asarray(src, dtype=np.int32),
        dst=np.asarray(dst, dtype=np.int32),
        label=np.asarray(label, dtype=np.int32),
        weight=np.asarray(weight, dtype=np.float32),
        arc_id=np.asarray(arc_id, dtype=np.int32),
        start=start,
        accept=accept,
        eps_src=np.asarray(esrc, dtype=np.int32),
        eps_dst=np.asarray(edst, dtype=np.int32),
        eps_weight=np.asarray(eweight, dtype=np.float32),
        eps_arc_id=np.asarray(earc_id, dtype=np.int32),
        eps_depth=_eps_depth(g),
    )


class DecodeTemplate(NamedTuple):
    """Weight-independent epsilon-removed structure for tropical decode
    tables: which arcs exist, and which original arcs each derives from.

    weight[i] = sum(w[contrib_ids[indptr[i]:indptr[i+1]]])
    accept[s] = max over final terms t at s of
                final_const[t] + sum(w[f_contrib[f_indptr[t]:f_indptr[t+1]]])
    """

    src: np.ndarray
    dst: np.ndarray
    label: np.ndarray
    start: np.ndarray
    contrib_ids: np.ndarray
    indptr: np.ndarray
    final_state: np.ndarray
    final_const: np.ndarray
    f_contrib: np.ndarray
    f_indptr: np.ndarray
    num_states: int


_MAX_EPS_PATHS = 100000  # epsilon paths out of one state before refusing


def build_decode_template(g: Graph) -> DecodeTemplate:
    """One-time structural epsilon removal with arc-id provenance: every
    epsilon run folds into the following emitting arc, trailing runs into
    finals.  Dead states are kept (their NEG accept potential excludes them
    from any tropical best path)."""
    eps_adj, nonteps = {}, {}
    for i in range(g.num_arcs()):
        il, ol = g.arc_ilabel[i], g.arc_olabel[i]
        if il == EPSILON and ol == EPSILON:
            eps_adj.setdefault(g.arc_src[i], []).append(i)
        else:
            if il == EPSILON or ol == EPSILON:
                raise ValueError(
                    "build_decode_template requires an acceptor"
                )
            nonteps.setdefault(g.arc_src[i], []).append(i)

    src, dst, label = [], [], []
    contrib, indptr = [], [0]
    f_state, f_const, f_contrib, f_indptr = [], [], [], [0]
    for s in range(g.num_nodes()):
        # all epsilon paths out of s, with the arc ids along each
        stack = [(s, (), frozenset([s]))]
        paths = []
        while stack:
            u, ids, onpath = stack.pop()
            paths.append((u, ids))
            if len(paths) > _MAX_EPS_PATHS:
                raise ValueError("epsilon path explosion")
            for a in eps_adj.get(u, ()):
                v = g.arc_dst[a]
                if v in onpath:
                    raise ValueError("epsilon cycle detected")
                stack.append((v, ids + (a,), onpath | {v}))
        for u, ids in paths:
            for fw in g.finals.get(u, ()):
                f_state.append(s)
                f_const.append(fw)
                f_contrib.extend(ids)
                f_indptr.append(len(f_contrib))
            for a in nonteps.get(u, ()):
                src.append(s)
                dst.append(g.arc_dst[a])
                label.append(g.arc_ilabel[a])
                contrib.extend(ids)
                contrib.append(a)
                indptr.append(len(contrib))

    start = np.full((g.num_nodes(),), NEG, dtype=np.float32)
    for s in g.start_nodes():
        start[s] = 0.0
    return DecodeTemplate(
        src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32),
        label=np.asarray(label, np.int32),
        start=start,
        contrib_ids=np.asarray(contrib, np.int64),
        indptr=np.asarray(indptr, np.int64),
        final_state=np.asarray(f_state, np.int64),
        final_const=np.asarray(f_const, np.float64),
        f_contrib=np.asarray(f_contrib, np.int64),
        f_indptr=np.asarray(f_indptr, np.int64),
        num_states=g.num_nodes(),
    )


def _segment_sums(w, ids, indptr):
    cs = np.concatenate([[0.0], np.cumsum(w[ids])])
    return cs[indptr[1:]] - cs[indptr[:-1]]


def apply_decode_weights(tmpl: DecodeTemplate, weights):
    """Re-weight a DecodeTemplate -> tropical decode ArcTable in O(nnz)."""
    w = np.asarray(weights, dtype=np.float64)
    weight = _segment_sums(w, tmpl.contrib_ids, tmpl.indptr)
    accept = np.full((tmpl.num_states,), NEG, dtype=np.float64)
    if len(tmpl.final_state):
        terms = tmpl.final_const + _segment_sums(
            w, tmpl.f_contrib, tmpl.f_indptr
        )
        np.maximum.at(accept, tmpl.final_state, terms)
    empty_i, empty_f = np.asarray([], np.int32), np.asarray([], np.float32)
    cg = CompiledGraph(
        src=tmpl.src, dst=tmpl.dst, label=tmpl.label,
        weight=weight.astype(np.float32),
        arc_id=np.arange(len(tmpl.src), dtype=np.int32),
        start=tmpl.start, accept=accept.astype(np.float32),
        eps_src=empty_i, eps_dst=empty_i, eps_weight=empty_f,
        eps_arc_id=empty_i, eps_depth=0,
    )
    return to_arc_table(cg)


def to_arc_table(cg: CompiledGraph, pad_arcs=None, pad_states=None, pad_eps=None):
    """Single CompiledGraph -> ArcTable of CPU tensors, padded to
    ``pad_arcs`` arcs, ``pad_states`` states and ``pad_eps`` epsilon arcs
    (default: their own counts, at least one arc and one state).  Padding
    arcs run from state 0 to the last state with weight NEG; padding
    states have NEG start and accept potentials."""
    A = pad_arcs or max(len(cg.src), 1)
    S = pad_states or max(len(cg.start), 1)
    E = pad_eps if pad_eps is not None else len(cg.eps_src)
    if len(cg.src) > A or len(cg.eps_src) > E:
        raise ValueError(f"arc counts {len(cg.src)}/{len(cg.eps_src)} exceed "
                         f"the pad sizes {A}/{E}")

    def pad(x, size, value, dtype):
        x = np.asarray(x, dtype)
        return torch.from_numpy(
            np.concatenate([x, np.full(size - len(x), value, dtype)]))

    return ArcTable(
        src=pad(cg.src, A, 0, np.int32),
        dst=pad(cg.dst, A, S - 1, np.int32),
        label=pad(cg.label, A, 0, np.int32),
        weight=pad(cg.weight, A, NEG, np.float32),
        start=pad(cg.start, S, NEG, np.float32),
        accept=pad(cg.accept, S, NEG, np.float32),
        eps_src=pad(cg.eps_src, E, 0, np.int32),
        eps_dst=pad(cg.eps_dst, E, S - 1, np.int32),
        eps_weight=pad(cg.eps_weight, E, NEG, np.float32),
        eps_depth=cg.eps_depth,
    )


def _round_up(x, multiple):
    return ((max(x, 1) + multiple - 1) // multiple) * multiple


def _union_slots(per_sample_pairs):
    """Align per-sample (src, dst) arc lists onto a shared union skeleton.

    Slot identity is (src, dst, occurrence): the k-th arc between the same
    state pair in any sample lands in the same slot, so a sample that lacks
    an arc leaves that slot dead (NEG weight).  Returns (src_u, dst_u,
    positions) where positions[b][i] is the slot of sample b's i-th arc."""
    counts = {}
    per_sample_keys = []
    for pairs in per_sample_pairs:
        occ = {}
        keys = []
        for sd in pairs:
            k = occ.get(sd, 0)
            occ[sd] = k + 1
            keys.append((sd[0], sd[1], k))
        per_sample_keys.append(keys)
        for sd, c in occ.items():
            counts[sd] = max(counts.get(sd, 0), c)
    union = sorted((s, d, k) for (s, d), c in counts.items() for k in range(c))
    slot = {key: i for i, key in enumerate(union)}
    positions = [np.asarray([slot[k] for k in keys], np.int64)
                 for keys in per_sample_keys]
    src_u = np.asarray([k[0] for k in union], np.int32)
    dst_u = np.asarray([k[1] for k in union], np.int32)
    return src_u, dst_u, positions


def _tensors(**fields):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()}


def union_stack_arc_tables(cgs: Sequence[CompiledGraph], pad_multiple=8,
                           max_blowup=1.75):
    """Shared-skeleton stacking: 1-D src/dst (and epsilon endpoints) with
    per-sample [B, A] labels and weights ([B, S] start and accept, [B, E]
    epsilon weights).

    Returns (table, positions, eps_positions), where positions[b] maps
    sample b's arc order to union slots (for provenance arrays such as the
    Transducer's widx), or None when the union skeleton exceeds
    ``max_blowup`` times the largest per-sample arc count: structurally
    unrelated graphs, which ``stack_arc_tables`` stacks per sample."""
    B = len(cgs)
    max_A = max(max(len(c.src) for c in cgs), 1)
    max_E = max(len(c.eps_src) for c in cgs)
    src_u, dst_u, positions = _union_slots(
        [list(zip(c.src.tolist(), c.dst.tolist())) for c in cgs])
    if len(src_u) > max_blowup * max_A:
        return None
    if max_E:
        esrc_u, edst_u, eps_positions = _union_slots(
            [list(zip(c.eps_src.tolist(), c.eps_dst.tolist())) for c in cgs])
        if len(esrc_u) > max_blowup * max_E:
            return None
    else:
        esrc_u = edst_u = np.zeros((0,), np.int32)
        eps_positions = [np.zeros((0,), np.int64) for _ in cgs]

    S = _round_up(max(len(c.start) for c in cgs), pad_multiple)
    A = _round_up(len(src_u), pad_multiple)
    E = _round_up(len(esrc_u), pad_multiple) if len(esrc_u) else 0
    depth = max(c.eps_depth for c in cgs)

    def pad_ends(src, dst, n):
        return (np.concatenate([src, np.zeros(n - len(src), np.int32)]),
                np.concatenate([dst, np.full(n - len(dst), S - 1, np.int32)]))

    src_u, dst_u = pad_ends(src_u, dst_u, A)
    esrc_u, edst_u = pad_ends(esrc_u, edst_u, E)
    label = np.zeros((B, A), np.int32)
    weight = np.full((B, A), NEG, np.float32)
    start = np.full((B, S), NEG, np.float32)
    accept = np.full((B, S), NEG, np.float32)
    eps_weight = np.full((B, E), NEG, np.float32)
    for b, c in enumerate(cgs):
        label[b, positions[b]] = c.label
        weight[b, positions[b]] = c.weight
        start[b, : len(c.start)] = c.start
        accept[b, : len(c.accept)] = c.accept
        if E and len(c.eps_src):
            eps_weight[b, eps_positions[b]] = c.eps_weight
    table = ArcTable(
        **_tensors(src=src_u, dst=dst_u, label=label, weight=weight,
                   start=start, accept=accept, eps_src=esrc_u,
                   eps_dst=edst_u, eps_weight=eps_weight),
        eps_depth=depth,
    )
    return table, positions, eps_positions


def stack_arc_tables(cgs: Sequence[CompiledGraph], pad_multiple=8):
    """Pad a batch of CompiledGraphs to shared shapes and stack: an
    ArcTable with a leading batch dimension on every field."""
    A = _round_up(max(len(c.src) for c in cgs), pad_multiple)
    S = _round_up(max(len(c.start) for c in cgs), pad_multiple)
    E = max(len(c.eps_src) for c in cgs)
    if E:
        E = _round_up(E, pad_multiple)
    depth = max(c.eps_depth for c in cgs)
    tables = [to_arc_table(c._replace(eps_depth=depth), A, S, E) for c in cgs]
    fields = ("src", "dst", "label", "weight", "start", "accept", "eps_src",
              "eps_dst", "eps_weight")
    return ArcTable(
        **{f: torch.stack([getattr(t, f) for t in tables]) for f in fields},
        eps_depth=depth,
    )
