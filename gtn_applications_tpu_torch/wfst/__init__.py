"""Host WFST front of the port: graphs and their files, the graph
operations, their compiled arc tables, and the bindings to the native graph
compiler.

``Graph`` with its text and binary files and ``write_dot``; the graph
operations of ``wfst.ops`` (``compose``/``intersect``, ``remove``,
``trim``, the projections, ``forward_score``, ``viterbi_score``,
``viterbi_path``, ``equal``, ``isomorphic``), each through the native graph
compiler where JAX's takes it; ``compile_acceptor`` in the log and tropical
semirings, the decode template, ``to_arc_table`` and the batch stacking of
the sparse tier; and ``native``, with ``compile_alignment`` and the decode
cleanups.
"""

from .compile import (
    CompiledGraph, DecodeTemplate, apply_decode_weights, build_decode_template,
    compile_acceptor, stack_arc_tables, to_arc_table, union_stack_arc_tables,
)
from .graph import (
    EPSILON, Graph, linear_graph, load, loadtxt, save, savetxt, write_dot,
)
from .ops import (
    compose, equal, forward_score, intersect, isomorphic, project_input,
    project_output, remove, trim, viterbi_path, viterbi_score,
)
