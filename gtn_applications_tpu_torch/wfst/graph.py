"""Host-side weighted finite-state transducer graphs (no file I/O).

Counterpart of the ``Graph`` class and ``linear_graph`` of
``gtn_applications_tpu/wfst/graph.py``, kept as a copy so that the port
does not import the JAX package (whose ``wfst`` package imports JAX).
What the STC label graphs and the Transducer's builders need is here:
building nodes and arcs, arc sorting, and the counts and start nodes that
``wfst.compile`` reads.  Graphs are built on
the host once per target and compiled to fixed-shape tables that the
device recursions consume.

Accepting states carry a *multiset* of final weights, as in the JAX class.
"""

from typing import Dict, List

EPSILON = -1


class Graph:
    """Mutable WFST with integer labels, ``EPSILON`` (= -1) allowed.

    ``add_node`` returns the node index; ``add_arc`` accepts (src, dst,
    label) for acceptor arcs or (src, dst, ilabel, olabel, weight).
    """

    def __init__(self):
        self.start: List[bool] = []
        # node -> list of final weights (one entry per way of accepting there)
        self.finals: Dict[int, List[float]] = {}
        self.arc_src: List[int] = []
        self.arc_dst: List[int] = []
        self.arc_ilabel: List[int] = []
        self.arc_olabel: List[int] = []
        self.arc_weight: List[float] = []

    def add_node(self, start=False, accept=False):
        self.start.append(bool(start))
        idx = len(self.start) - 1
        if accept:
            self.finals[idx] = [0.0]
        return idx

    def add_arc(self, src, dst, ilabel, olabel=None, weight=0.0):
        if olabel is None:
            olabel = ilabel
        self.arc_src.append(int(src))
        self.arc_dst.append(int(dst))
        self.arc_ilabel.append(int(ilabel))
        self.arc_olabel.append(int(olabel))
        self.arc_weight.append(float(weight))
        return len(self.arc_src) - 1

    def num_nodes(self):
        return len(self.start)

    def num_arcs(self):
        return len(self.arc_src)

    def start_nodes(self):
        return [i for i, s in enumerate(self.start) if s]

    def arc_sort(self):
        """Order the arcs by (source, input label); gtn.arc_sort is a
        performance hint, here it fixes the arc order the compiled tables
        follow."""
        order = sorted(
            range(self.num_arcs()),
            key=lambda i: (self.arc_src[i], self.arc_ilabel[i]),
        )
        self.arc_src = [self.arc_src[i] for i in order]
        self.arc_dst = [self.arc_dst[i] for i in order]
        self.arc_ilabel = [self.arc_ilabel[i] for i in order]
        self.arc_olabel = [self.arc_olabel[i] for i in order]
        self.arc_weight = [self.arc_weight[i] for i in order]
        return self

    def __repr__(self):
        return (
            f"Graph(nodes={self.num_nodes()}, arcs={self.num_arcs()}, "
            f"start={self.start_nodes()}, accept={sorted(self.finals)})"
        )


def linear_graph(sequence):
    """A chain acceptor over a label sequence: node i -> i + 1 on
    sequence[i], node 0 starts, the last node accepts.  (The JAX function's
    ``(T, C)`` emission-lattice form is not needed by the port.)"""
    g = Graph()
    seq = list(sequence)
    g.add_node(True, len(seq) == 0)
    for i, s in enumerate(seq):
        g.add_node(False, i == len(seq) - 1)
        g.add_arc(i, i + 1, s)
    return g
