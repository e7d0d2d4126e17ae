"""Host-side weighted finite-state transducer graphs and their files.

Counterpart of the ``Graph`` class, ``linear_graph`` and the file I/O
(``savetxt``/``loadtxt``, the binary ``save``/``load``) of
``gtn_applications_tpu/wfst/graph.py``, kept as a copy so that the port
does not import the JAX package (whose ``wfst`` package imports JAX).
What the STC label graphs, the Transducer's builders, its loaded
transition graphs and the graph operations of ``wfst.ops`` need is here:
building nodes and arcs, copying, arc sorting, the counts, start and accept
nodes and adjacency lists, the weights and labels along arc order, and the
Graphviz dump ``write_dot``.
Graphs are built on the host once per target and compiled to fixed-shape
tables that the device recursions consume.

Accepting states carry a *multiset* of final weights, as in the JAX class.
Both packages read and write the same files: the text format of GTN's
``savetxt`` and a little-endian binary format with the magic ``TWFST001``.
"""

import struct
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

    def add_final(self, node, weight=0.0):
        self.finals.setdefault(node, []).append(float(weight))

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

    def accept_nodes(self):
        return sorted(self.finals)

    def is_accept(self, node):
        return node in self.finals

    def num_start(self):
        return sum(self.start)

    def num_accept(self):
        return len(self.finals)

    def out_arcs(self):
        """Adjacency: the arc indices leaving each node, in arc order."""
        adj = [[] for _ in range(self.num_nodes())]
        for i, s in enumerate(self.arc_src):
            adj[s].append(i)
        return adj

    def in_arcs(self):
        """The arc indices entering each node, in arc order."""
        adj = [[] for _ in range(self.num_nodes())]
        for i, d in enumerate(self.arc_dst):
            adj[d].append(i)
        return adj

    def arcs(self):
        """Iterate (src, dst, ilabel, olabel, weight) tuples."""
        return zip(self.arc_src, self.arc_dst, self.arc_ilabel,
                   self.arc_olabel, self.arc_weight)

    def is_acceptor(self):
        return all(i == o for i, o in zip(self.arc_ilabel, self.arc_olabel))

    def has_simple_finals(self):
        return all(ws == [0.0] for ws in self.finals.values())

    def weights(self):
        return list(self.arc_weight)

    def labels_to_list(self, ilabel=True):
        """Labels along arc order, epsilons dropped (gtn's
        ``labels_to_list``)."""
        labels = self.arc_ilabel if ilabel else self.arc_olabel
        return [l for l in labels if l != EPSILON]

    def set_weights(self, weights):
        """Overwrite all arc weights from a flat sequence."""
        weights = [float(w) for w in weights]
        if len(weights) != self.num_arcs():
            raise ValueError(
                f"set_weights got {len(weights)} weights for {self.num_arcs()} arcs"
            )
        self.arc_weight = weights

    def copy(self):
        g = Graph()
        g.start = list(self.start)
        g.finals = {k: list(v) for k, v in self.finals.items()}
        g.arc_src = list(self.arc_src)
        g.arc_dst = list(self.arc_dst)
        g.arc_ilabel = list(self.arc_ilabel)
        g.arc_olabel = list(self.arc_olabel)
        g.arc_weight = list(self.arc_weight)
        return g

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
            f"start={self.start_nodes()}, accept={self.accept_nodes()})"
        )


def savetxt(path_or_file, g: Graph):
    """GTN text format: start line, accept line, then
    ``src dst ilabel olabel weight`` rows (the format of
    ``tests/goldens/trans_backoff_test.txt``)."""
    if not g.has_simple_finals():
        raise ValueError("text format cannot represent weighted finals")
    lines = [
        " ".join(str(i) for i in g.start_nodes()),
        " ".join(str(i) for i in g.accept_nodes()),
    ]
    for s, d, il, ol, w in g.arcs():
        lines.append(f"{s} {d} {il} {ol} {w:g}")
    data = "\n".join(lines) + "\n"
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "w") as fid:
            fid.write(data)


def loadtxt(path_or_file) -> Graph:
    if hasattr(path_or_file, "read"):
        text = path_or_file.read()
    else:
        with open(path_or_file, "r") as fid:
            text = fid.read()
    lines = text.splitlines()
    if len(lines) < 2:
        raise ValueError("invalid graph text: need start and accept lines")
    starts = {int(x) for x in lines[0].split()}
    accepts = {int(x) for x in lines[1].split()}
    max_node = max(starts | accepts, default=-1)
    arcs = []
    for line in lines[2:]:
        parts = line.split()
        if not parts:
            continue
        if len(parts) == 3:
            s, d, il = (int(p) for p in parts)
            ol, w = il, 0.0
        elif len(parts) == 4:
            s, d, il, ol = (int(p) for p in parts)
            w = 0.0
        elif len(parts) == 5:
            s, d, il, ol = (int(p) for p in parts[:4])
            w = float(parts[4])
        else:
            raise ValueError(f"invalid arc line: {line!r}")
        arcs.append((s, d, il, ol, w))
        max_node = max(max_node, s, d)
    g = Graph()
    for i in range(max_node + 1):
        g.add_node(i in starts, i in accepts)
    for arc in arcs:
        g.add_arc(*arc)
    return g


_MAGIC = b"TWFST001"


def save(path, g: Graph):
    """Binary file: the magic, node/arc/final counts (int64), start flags
    (uint8), (node int64, weight float32) finals, then the arcs' src, dst,
    ilabel, olabel (int64 each) and weights (float32), little-endian."""
    n, a = g.num_nodes(), g.num_arcs()
    finals = [(node, w) for node, ws in sorted(g.finals.items()) for w in ws]
    with open(path, "wb") as fid:
        fid.write(_MAGIC)
        fid.write(struct.pack("<qqq", n, a, len(finals)))
        fid.write(struct.pack(f"<{n}B", *[int(x) for x in g.start]))
        for node, w in finals:
            fid.write(struct.pack("<qf", node, w))
        for field in (g.arc_src, g.arc_dst, g.arc_ilabel, g.arc_olabel):
            fid.write(struct.pack(f"<{a}q", *field))
        fid.write(struct.pack(f"<{a}f", *g.arc_weight))


def load(path) -> Graph:
    with open(path, "rb") as fid:
        if fid.read(8) != _MAGIC:
            raise ValueError(f"not a {_MAGIC!r} graph file")
        n, a, nf = struct.unpack("<qqq", fid.read(24))
        g = Graph()
        for s in struct.unpack(f"<{n}B", fid.read(n)):
            g.add_node(bool(s), False)
        for _ in range(nf):
            node, w = struct.unpack("<qf", fid.read(12))
            g.add_final(node, w)
        fields = [struct.unpack(f"<{a}q", fid.read(8 * a)) for _ in range(4)]
        weights = struct.unpack(f"<{a}f", fid.read(4 * a))
        for arc in zip(*fields, weights):
            g.add_arc(*arc)
        return g


def write_dot(g: Graph, path, isymbols=None, osymbols=None):
    """Graphviz dump for debugging: accepting nodes double circles, start
    nodes bold, arcs ``ilabel[:olabel]/weight`` through the optional
    symbol tables (epsilon as "ε")."""
    def sym(table, label):
        if label == EPSILON:
            return "ε"
        if table is not None and label in table:
            return str(table[label])
        return str(label)

    lines = ["digraph FST {", "rankdir = LR;"]
    for i in range(g.num_nodes()):
        shape = "doublecircle" if g.is_accept(i) else "circle"
        style = ' style="bold"' if g.start[i] else ""
        lines.append(f'  {i} [shape={shape}{style}];')
    for s, d, il, ol, w in g.arcs():
        label = sym(isymbols, il)
        if il != ol or osymbols is not None:
            label += ":" + sym(osymbols, ol)
        lines.append(f'  {s} -> {d} [label="{label}/{w:.4g}"];')
    lines.append("}")
    with open(path, "w") as fid:
        fid.write("\n".join(lines) + "\n")


def linear_graph(sequence_or_T, num_labels=None):
    """A chain acceptor over a label sequence (node i -> i + 1 on
    sequence[i], node 0 starts, the last node accepts); or, with
    ``num_labels`` C, the T x C emission-lattice skeleton (gtn's
    ``linear_graph(T, C)``): nodes 0..T, an arc t -> t + 1 for every label,
    its weights settable by ``set_weights`` in time-major label order."""
    g = Graph()
    if num_labels is None:
        seq = list(sequence_or_T)
        g.add_node(True, len(seq) == 0)
        for i, s in enumerate(seq):
            g.add_node(False, i == len(seq) - 1)
            g.add_arc(i, i + 1, s)
        return g
    T, C = int(sequence_or_T), int(num_labels)
    g.add_node(True, T == 0)
    for t in range(T):
        g.add_node(False, t == T - 1)
        for c in range(C):
            g.add_arc(t, t + 1, c)
    return g
