"""Host WFST algorithms: composition and intersection, epsilon removal,
projection, trimming, scoring, best paths and graph predicates.

Counterpart of ``gtn_applications_tpu/wfst/ops.py``, a copy kept in the
port.  ``compose``/``intersect`` use the standard three-state
epsilon-sequencing filter, ``remove`` keeps path multiplicity, and
``forward_score`` / ``viterbi_score`` / ``viterbi_path`` score small graphs
on the host, for tests and the offline scripts (``scripts/load_arpa.py``
checks its LM graph through ``intersect`` and ``viterbi_score``).  The hot
per-frame scoring runs on the card through ``ops.sparse``; these run once
per vocabulary or target.

``compose``, ``remove``, ``forward_score`` and ``viterbi_score`` take the
native graph compiler (``wfst.native``, ``native/libtwgraph.so``) where it
loads, as the JAX package does, and the Python versions (the ``*_py``
functions, also the native routes' test oracle) where it does not or where
``TW_NATIVE=0`` turns it off.
"""

import math
from collections import deque
from typing import Dict, List, Optional, Tuple

from .graph import EPSILON, Graph


# ---------------------------------------------------------------------------
# Composition with epsilon-sequencing filter
# ---------------------------------------------------------------------------


def compose_py(g1: Graph, g2: Graph, return_arc_map: bool = False):
    """Transducer composition matching g1 output labels to g2 input labels.

    Epsilon handling uses the standard three-state sequencing filter
    (states 0/1/2) so that parallel epsilon interleavings produce exactly
    one composite path: both-advance on matched labels (any filter state ->
    0), g1-only epsilon-output move (from 0/1 -> 1), g2-only epsilon-input
    move (from 0/2 -> 2), both-advance on paired epsilons (from 0 -> 0).

    With ``return_arc_map`` the provenance of every output arc is returned
    as a list of (g1_arc_or_-1, g2_arc_or_-1): this keeps learnable arc
    weights (e.g. transition params intersected into alignment graphs)
    addressable after host composition.
    """
    # index g2 arcs by (src, ilabel) and epsilon arcs by src
    g2_by_label: Dict[Tuple[int, int], List[int]] = {}
    g2_eps: Dict[int, List[int]] = {}
    for i in range(g2.num_arcs()):
        il = g2.arc_ilabel[i]
        s = g2.arc_src[i]
        if il == EPSILON:
            g2_eps.setdefault(s, []).append(i)
        else:
            g2_by_label.setdefault((s, il), []).append(i)

    g1_out = g1.out_arcs()

    out = Graph()
    state_map: Dict[Tuple[int, int, int], int] = {}
    queue = deque()

    def get_state(s1, s2, f):
        key = (s1, s2, f)
        node = state_map.get(key)
        if node is None:
            node = out.add_node(False, False)
            state_map[key] = node
            queue.append(key)
            if g1.is_accept(s1) and g2.is_accept(s2):
                for w1 in g1.finals[s1]:
                    for w2 in g2.finals[s2]:
                        out.add_final(node, w1 + w2)
        return node

    for s1 in g1.start_nodes():
        for s2 in g2.start_nodes():
            node = get_state(s1, s2, 0)
            out.start[node] = True

    prov: List[Tuple[int, int]] = []

    while queue:
        s1, s2, f = key = queue.popleft()
        src = state_map[key]
        for a1 in g1_out[s1]:
            ol1 = g1.arc_olabel[a1]
            d1 = g1.arc_dst[a1]
            il1 = g1.arc_ilabel[a1]
            w1 = g1.arc_weight[a1]
            if ol1 == EPSILON:
                # g1-only epsilon move (blocked after a g2-only move)
                if f != 2:
                    dst = get_state(d1, s2, 1)
                    out.add_arc(src, dst, il1, EPSILON, w1)
                    prov.append((a1, -1))
                # paired epsilon move (only from the neutral filter state)
                if f == 0:
                    for a2 in g2_eps.get(s2, ()):
                        dst = get_state(d1, g2.arc_dst[a2], 0)
                        out.add_arc(
                            src, dst, il1, g2.arc_olabel[a2],
                            w1 + g2.arc_weight[a2],
                        )
                        prov.append((a1, a2))
            else:
                for a2 in g2_by_label.get((s2, ol1), ()):
                    dst = get_state(d1, g2.arc_dst[a2], 0)
                    out.add_arc(
                        src, dst, il1, g2.arc_olabel[a2],
                        w1 + g2.arc_weight[a2],
                    )
                    prov.append((a1, a2))
        if f != 1:
            # g2-only epsilon move
            for a2 in g2_eps.get(s2, ()):
                dst = get_state(s1, g2.arc_dst[a2], 2)
                out.add_arc(src, dst, EPSILON, g2.arc_olabel[a2], g2.arc_weight[a2])
                prov.append((-1, a2))

    trimmed, kept = _trim_with_arc_map(out)
    if return_arc_map:
        return trimmed, [prov[a] for a in kept]
    return trimmed


def intersect(g1: Graph, g2: Graph) -> Graph:
    """Acceptor intersection (gtn.intersect): composition of acceptors."""
    return compose(g1, g2)


# ---------------------------------------------------------------------------
# Projection / trimming / epsilon removal
# ---------------------------------------------------------------------------


def project_input(g: Graph) -> Graph:
    out = g.copy()
    out.arc_olabel = list(out.arc_ilabel)
    return out


def project_output(g: Graph) -> Graph:
    out = g.copy()
    out.arc_ilabel = list(out.arc_olabel)
    return out


def trim(g: Graph) -> Graph:
    """Drop states not on any start -> accept path (connect/trim)."""
    return _trim_with_arc_map(g)[0]


def _trim_with_arc_map(g: Graph):
    """trim plus the list of kept original arc indices (in output order)."""
    n = g.num_nodes()
    fwd = [False] * n
    stack = list(g.start_nodes())
    out_adj = g.out_arcs()
    for s in stack:
        fwd[s] = True
    while stack:
        s = stack.pop()
        for a in out_adj[s]:
            d = g.arc_dst[a]
            if not fwd[d]:
                fwd[d] = True
                stack.append(d)
    bwd = [False] * n
    in_adj = g.in_arcs()
    stack = [s for s in g.finals if fwd[s]]
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for a in in_adj[s]:
            d = g.arc_src[a]
            if not bwd[d]:
                bwd[d] = True
                stack.append(d)
    keep = [i for i in range(n) if fwd[i] and bwd[i]]
    remap = {old: new for new, old in enumerate(keep)}
    out = Graph()
    for old in keep:
        out.add_node(g.start[old], False)
    for old in keep:
        if old in g.finals:
            for w in g.finals[old]:
                out.add_final(remap[old], w)
    kept = []
    for i in range(g.num_arcs()):
        s, d = g.arc_src[i], g.arc_dst[i]
        if s in remap and d in remap:
            out.add_arc(
                remap[s], remap[d], g.arc_ilabel[i], g.arc_olabel[i],
                g.arc_weight[i],
            )
            kept.append(i)
    return out, kept


def _eps_paths_from(g: Graph, s: int, eps_adj, max_paths=100000):
    """All epsilon paths from s (including the empty path): list of
    (end_state, weight).  Raises on epsilon cycles."""
    results = []
    stack = [(s, 0.0, frozenset([s]))]
    while stack:
        u, w, onpath = stack.pop()
        results.append((u, w))
        if len(results) > max_paths:
            raise ValueError("epsilon path explosion in remove()")
        for a in eps_adj.get(u, ()):
            v = g.arc_dst[a]
            if v in onpath:
                raise ValueError("epsilon cycle detected in remove()")
            stack.append((v, w + g.arc_weight[a], onpath | {v}))
    return results


def remove_py(g: Graph) -> Graph:
    """Epsilon removal preserving path weights *and* path multiplicity.

    Every original accepting path  eps* a1 eps* a2 ... an eps*  maps to
    exactly one path  a1' a2' ... an'  in the result (epsilon runs folded
    into the following arc, the trailing run into a final weight), matching
    GTN's path-sum semantics for forward_score.
    """
    eps_adj: Dict[int, List[int]] = {}
    nonteps: Dict[int, List[int]] = {}
    for i in range(g.num_arcs()):
        il, ol = g.arc_ilabel[i], g.arc_olabel[i]
        s = g.arc_src[i]
        if il == EPSILON and ol == EPSILON:
            eps_adj.setdefault(s, []).append(i)
        else:
            nonteps.setdefault(s, []).append(i)

    out = Graph()
    for i in range(g.num_nodes()):
        out.add_node(g.start[i], False)

    for s in range(g.num_nodes()):
        best_final = None
        for u, wp in _eps_paths_from(g, s, eps_adj):
            if u in g.finals:
                for fw in g.finals[u]:
                    cand = wp + fw
                    if best_final is None or cand > best_final:
                        best_final = cand
            for a in nonteps.get(u, ()):
                out.add_arc(
                    s, g.arc_dst[a], g.arc_ilabel[a], g.arc_olabel[a],
                    wp + g.arc_weight[a],
                )
        # GTN parity: acceptance via epsilon paths collapses to a single
        # final (gtn marks accept as a boolean). We keep the best (max)
        # weight so tropical decode tables built from weighted backoff
        # graphs stay exact; for the zero-weight epsilon arcs of the
        # reference's loss pipelines this is identical to GTN.
        if best_final is not None:
            out.add_final(s, best_final)
    return trim(out)


# ---------------------------------------------------------------------------
# Scoring (host, small graphs)
# ---------------------------------------------------------------------------


def _topo_order(g: Graph):
    n = g.num_nodes()
    indeg = [0] * n
    for d in g.arc_dst:
        indeg[d] += 1
    order = [i for i in range(n) if indeg[i] == 0]
    out_adj = g.out_arcs()
    head = 0
    while head < len(order):
        s = order[head]
        head += 1
        for a in out_adj[s]:
            d = g.arc_dst[a]
            indeg[d] -= 1
            if indeg[d] == 0:
                order.append(d)
    if len(order) != n:
        raise ValueError("graph has cycles; forward_score requires a DAG")
    return order


NEG = -1e30


def forward_score_py(g: Graph) -> float:
    """Log-semiring shortest distance start -> accept (gtn.forward_score)."""
    order = _topo_order(g)
    alpha = [NEG] * g.num_nodes()
    for s in g.start_nodes():
        alpha[s] = _logadd(alpha[s], 0.0)
    out_adj = g.out_arcs()
    for s in order:
        if alpha[s] <= NEG / 2:
            continue
        for a in out_adj[s]:
            d = g.arc_dst[a]
            alpha[d] = _logadd(alpha[d], alpha[s] + g.arc_weight[a])
    score = NEG
    for s, ws in g.finals.items():
        for w in ws:
            if alpha[s] > NEG / 2:
                score = _logadd(score, alpha[s] + w)
    return score


def viterbi_score_py(g: Graph) -> float:
    order = _topo_order(g)
    alpha = [NEG] * g.num_nodes()
    for s in g.start_nodes():
        alpha[s] = 0.0
    out_adj = g.out_arcs()
    for s in order:
        if alpha[s] <= NEG / 2:
            continue
        for a in out_adj[s]:
            d = g.arc_dst[a]
            alpha[d] = max(alpha[d], alpha[s] + g.arc_weight[a])
    return max(
        (alpha[s] + w for s, ws in g.finals.items() for w in ws if alpha[s] > NEG / 2),
        default=NEG,
    )


def viterbi_path(g: Graph) -> Graph:
    """Best path as a chain Graph (gtn.viterbi_path)."""
    order = _topo_order(g)
    alpha = [NEG] * g.num_nodes()
    back: List[Optional[int]] = [None] * g.num_nodes()
    for s in g.start_nodes():
        alpha[s] = 0.0
    out_adj = g.out_arcs()
    for s in order:
        if alpha[s] <= NEG / 2:
            continue
        for a in out_adj[s]:
            d = g.arc_dst[a]
            cand = alpha[s] + g.arc_weight[a]
            if cand > alpha[d]:
                alpha[d] = cand
                back[d] = a
    best_state, best_score = None, NEG
    for s, ws in g.finals.items():
        for w in ws:
            if alpha[s] > NEG / 2 and alpha[s] + w > best_score:
                best_score = alpha[s] + w
                best_state = s
    path = Graph()
    if best_state is None:
        return path
    arcs = []
    s = best_state
    while back[s] is not None:
        a = back[s]
        arcs.append(a)
        s = g.arc_src[a]
    arcs.reverse()
    path.add_node(True, len(arcs) == 0)
    for i, a in enumerate(arcs):
        path.add_node(False, i == len(arcs) - 1)
        path.add_arc(
            i, i + 1, g.arc_ilabel[a], g.arc_olabel[a], g.arc_weight[a]
        )
    return path


def _logadd(a, b):
    if a <= NEG / 2:
        return b
    if b <= NEG / 2:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


def equal(g1: Graph, g2: Graph) -> bool:
    """Structural equality up to arc ordering (gtn.equal)."""
    if g1.num_nodes() != g2.num_nodes():
        return False
    if g1.start != g2.start:
        return False
    f1 = {k: sorted(v) for k, v in g1.finals.items()}
    f2 = {k: sorted(v) for k, v in g2.finals.items()}
    if f1 != f2:
        return False
    return sorted(g1.arcs()) == sorted(g2.arcs())


def isomorphic(g1: Graph, g2: Graph) -> bool:
    """Graph isomorphism by backtracking node matching (gtn.isomorphic).

    Suitable for the small builder graphs of the tests.
    """
    if (
        g1.num_nodes() != g2.num_nodes()
        or g1.num_arcs() != g2.num_arcs()
        or g1.num_start() != g2.num_start()
        or g1.num_accept() != g2.num_accept()
    ):
        return False

    out1, out2 = g1.out_arcs(), g2.out_arcs()

    def node_sig(g, out, i):
        return (
            g.start[i],
            tuple(sorted(g.finals.get(i, []))),
            len(out[i]),
        )

    mapping: Dict[int, int] = {}
    reverse: Dict[int, int] = {}

    def arcs_match(i, j):
        # multiset of (il, ol, w, mapped_dst or None)
        def key(g, out, node):
            items = []
            for a in out[node]:
                items.append(
                    (g.arc_ilabel[a], g.arc_olabel[a], round(g.arc_weight[a], 6))
                )
            return sorted(items)

        return key(g1, out1, i) == key(g2, out2, j)

    def try_map(i, j):
        if i in mapping:
            return mapping[i] == j
        if j in reverse:
            return False
        if node_sig(g1, out1, i) != node_sig(g2, out2, j):
            return False
        if not arcs_match(i, j):
            return False
        mapping[i] = j
        reverse[j] = i
        # group arcs by (il, ol, w); candidate dst sets must match recursively
        groups1: Dict[tuple, List[int]] = {}
        groups2: Dict[tuple, List[int]] = {}
        for a in out1[i]:
            groups1.setdefault(
                (g1.arc_ilabel[a], g1.arc_olabel[a], round(g1.arc_weight[a], 6)), []
            ).append(g1.arc_dst[a])
        for a in out2[j]:
            groups2.setdefault(
                (g2.arc_ilabel[a], g2.arc_olabel[a], round(g2.arc_weight[a], 6)), []
            ).append(g2.arc_dst[a])

        def match_group(dsts1, dsts2):
            if not dsts1:
                return True
            d1 = dsts1[0]
            rest1 = dsts1[1:]
            for k, d2 in enumerate(dsts2):
                state = (dict(mapping), dict(reverse))
                if try_map(d1, d2):
                    if match_group(rest1, dsts2[:k] + dsts2[k + 1 :]):
                        return True
                mapping.clear()
                mapping.update(state[0])
                reverse.clear()
                reverse.update(state[1])
            return False

        for key in groups1:
            if key not in groups2 or len(groups1[key]) != len(groups2[key]):
                del mapping[i]
                del reverse[j]
                return False
        for key in groups1:
            if not match_group(groups1[key], groups2[key]):
                del mapping[i]
                del reverse[j]
                return False
        return True

    starts1 = g1.start_nodes()
    starts2 = g2.start_nodes()

    def match_starts(s1_list):
        if not s1_list:
            return True
        s1 = s1_list[0]
        for s2 in starts2:
            state = (dict(mapping), dict(reverse))
            if try_map(s1, s2) and match_starts(s1_list[1:]):
                return True
            mapping.clear()
            mapping.update(state[0])
            reverse.clear()
            reverse.update(state[1])
        return False

    return match_starts(starts1)

# ---------------------------------------------------------------------------
# Native dispatch: the C++ graph compiler (wfst.native, native/libtwgraph.so)
# implements these with the same semantics; the Python versions above are
# the fallback and the test oracle.
# ---------------------------------------------------------------------------


def _use_native():
    from . import native as _native

    return _native.enabled()


def compose(g1: Graph, g2: Graph, return_arc_map: bool = False):
    if _use_native():
        from . import native as _native

        return _native.compose(g1, g2, return_arc_map)
    return compose_py(g1, g2, return_arc_map)


compose.__doc__ = compose_py.__doc__


def remove(g: Graph) -> Graph:
    if _use_native():
        from . import native as _native

        return _native.remove(g)
    return remove_py(g)


remove.__doc__ = remove_py.__doc__


def forward_score(g: Graph) -> float:
    if _use_native():
        from . import native as _native

        return _native.forward_score(g)
    return forward_score_py(g)


forward_score.__doc__ = forward_score_py.__doc__


def viterbi_score(g: Graph) -> float:
    if _use_native():
        from . import native as _native

        return _native.viterbi_score(g)
    return viterbi_score_py(g)


viterbi_score.__doc__ = viterbi_score_py.__doc__
