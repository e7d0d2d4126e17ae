"""Host WFST front of the port: graphs and their files, their compiled arc
tables, and the bindings to the native graph compiler.

What the STC tiers and the Transducer's paths need is here (``Graph`` with
its text and binary files, ``compile_acceptor`` without epsilon removal,
the decode template, ``to_arc_table`` and the batch stacking of the
sparse tier, ``native.compile_alignment``).  Epsilon removal inside
``compile_acceptor`` and the pure-Python composition (``wfst/ops.py``)
wait for ROADMAP queue A item 7.
"""

from .compile import (
    CompiledGraph, DecodeTemplate, apply_decode_weights, build_decode_template,
    compile_acceptor, stack_arc_tables, to_arc_table, union_stack_arc_tables,
)
from .graph import EPSILON, Graph, linear_graph, load, loadtxt, save, savetxt
