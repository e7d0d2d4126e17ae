"""Host WFST front of the port: graphs, their compiled arc tables, and the
bindings to the native graph compiler.

What the STC dense tier and the Transducer's factored path need is here
(``Graph``, ``compile_acceptor`` without epsilon removal, the decode
template, ``to_arc_table``, ``native.compile_alignment``).  The sparse
arc-table tier, epsilon removal and the pure-Python composition
(``wfst/ops.py``) wait for ROADMAP queue A item 7.
"""

from .compile import (
    CompiledGraph, DecodeTemplate, apply_decode_weights, build_decode_template,
    compile_acceptor, to_arc_table,
)
from .graph import EPSILON, Graph, linear_graph
