"""Host WFST front of the port: graphs and their files, their compiled arc
tables, and the bindings to the native graph compiler.

What the STC tiers and the Transducer's paths need is here (``Graph`` with
its text and binary files, ``compile_acceptor`` in the log and tropical
semirings, with epsilon removal through the native graph compiler, the
decode template, ``to_arc_table`` and the batch stacking of the sparse
tier, ``native.compile_alignment`` and ``native.forced_collapse``).  The
pure-Python graph operations of JAX's ``wfst/ops.py`` are not ported.
"""

from .compile import (
    CompiledGraph, DecodeTemplate, apply_decode_weights, build_decode_template,
    compile_acceptor, stack_arc_tables, to_arc_table, union_stack_arc_tables,
)
from .graph import EPSILON, Graph, linear_graph, load, loadtxt, save, savetxt
