"""Host WFST front of the port: graphs and their compiled arc tables.

Only what the STC dense tier needs is here (``Graph``, ``compile_acceptor``
without epsilon removal).  The sparse arc-table tier, epsilon removal and
the native graph bindings wait for ROADMAP queue A item 7.
"""

from .compile import CompiledGraph, compile_acceptor
from .graph import EPSILON, Graph
