"""Compile host Graphs into fixed-shape numpy arc tables.

Counterpart of ``CompiledGraph``, ``_eps_depth``, ``compile_acceptor``,
the decode template (``DecodeTemplate``, ``build_decode_template``,
``apply_decode_weights``) and ``to_arc_table`` of
``gtn_applications_tpu/wfst/compile.py``: an acceptor Graph becomes numpy
arrays (emitting arcs, epsilon arcs with their closure depth, start and
accept potentials), and a transition graph with learnable arc weights
becomes an epsilon-free tropical decode ``ArcTable`` re-weighted per
parameter update in O(nnz) numpy.  Epsilon removal inside
``compile_acceptor`` (``remove_eps=True``) and the stacked arc tables of
the sparse scorer are not ported yet (ROADMAP queue A item 7).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops.semiring import NEG
from ..ops.sparse import ArcTable
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


def compile_acceptor(g: Graph, remove_eps: bool = False) -> CompiledGraph:
    """Compile an acceptor Graph to arc tables, in the log semiring
    (parallel final weights of a node combine by logsumexp; the JAX
    function's ``semiring='tropical'`` option waits for the decoders that
    use it).

    Args:
      remove_eps: must be False: epsilon removal is not ported yet.
    """
    if remove_eps:
        raise NotImplementedError(
            "compile_acceptor(remove_eps=True) needs epsilon removal, which "
            "is not ported yet (ROADMAP queue A item 7, sparse WFST tier)"
        )

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
        m = ws.max()
        accept[s] = m + np.log(np.exp(ws - m).sum())

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


def to_arc_table(cg: CompiledGraph):
    """Single CompiledGraph -> ArcTable of CPU tensors.  A graph without
    arcs (or states) gets one padding arc from state 0 to the last state
    with weight NEG (one state with NEG start and accept potentials)."""
    A = max(len(cg.src), 1)
    S = max(len(cg.start), 1)
    E = len(cg.eps_src)

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
