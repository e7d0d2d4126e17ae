"""Compile host Graphs into fixed-shape numpy arc tables.

Counterpart of ``CompiledGraph``, ``_eps_depth`` and ``compile_acceptor``
of ``gtn_applications_tpu/wfst/compile.py``: an acceptor Graph becomes
numpy arrays (emitting arcs, epsilon arcs with their closure depth, start
and accept potentials).  Epsilon removal (``remove_eps=True``), the padded
and stacked arc tables and the sparse scorer they feed are not ported yet
(ROADMAP queue A item 7).
"""

from typing import NamedTuple

import numpy as np

from ..ops.semiring import NEG
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
