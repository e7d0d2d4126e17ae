"""ctypes bindings to the native (C++) graph compiler, for the Transducer.

Counterpart of the parts of ``gtn_applications_tpu/wfst/native.py`` that
the Transducer's factored path calls: loading ``native/libtwgraph.so``,
``to_native`` and the one-call per-target pipeline ``compile_alignment``.
Both packages share the library; its source is ``native/graph_compiler.cc``
at the root of the checkout.  The ``.so`` is not committed: the first call
builds it with ``make -C native`` (g++), under a file lock in ``build/``
so that concurrent processes build it once.  If it cannot be built, the call
raises and says how to build it; there is no pure-Python fallback in the
port (``wfst/ops.py`` waits for ROADMAP queue A item 7).
"""

import ctypes
import fcntl
import subprocess
import threading
from pathlib import Path

import numpy as np

from .graph import Graph

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "libtwgraph.so"
LOCK_PATH = NATIVE_DIR.parent / "build" / "native-build.lock"

_LIB = None
_lock = threading.Lock()


def _build():
    """``make -C native`` under an exclusive lock in the ignored ``build/``."""
    if not (NATIVE_DIR / "graph_compiler.cc").exists():
        raise RuntimeError(f"the native graph compiler's source is missing in {NATIVE_DIR}")
    LOCK_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if LIB_PATH.exists():
                return
            out = subprocess.run(
                ["make", "-C", str(NATIVE_DIR)], capture_output=True, text=True,
                timeout=600,
            )
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if out.returncode != 0 or not LIB_PATH.exists():
        raise RuntimeError(
            f"building {LIB_PATH} failed; build it with `make -C native` "
            f"(needs g++ and make):\n{out.stdout}\n{out.stderr}"
        )


def load_library():
    """The ctypes handle of ``native/libtwgraph.so``, built on first use."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        if not LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.tw_graph_new.restype = ctypes.c_void_p
        lib.tw_graph_new.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.tw_graph_free.argtypes = [ctypes.c_void_p]
        lib.tw_graph_warm.argtypes = [ctypes.c_void_p]
        lib.tw_compile_alignment.restype = ctypes.c_void_p
        lib.tw_compile_alignment.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.tw_tables_free.argtypes = [ctypes.c_void_p]
        lib.tw_tables_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tw_tables_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
        _LIB = lib
        return lib


class _Handle:
    """Owns a native graph handle."""

    def __init__(self, lib, h):
        self.lib = lib
        self.h = h

    def __del__(self):
        if self.h:
            self.lib.tw_graph_free(self.h)
            self.h = None


def to_native(g: Graph, warm=False):
    """Convert to a native handle; ``warm`` pre-builds the compose index
    (required before sharing the handle across threads)."""
    lib = load_library()
    start = np.asarray(g.start, dtype=np.uint8)
    finals = [(n, w) for n, ws in sorted(g.finals.items()) for w in ws]
    fnode = np.asarray([f[0] for f in finals], dtype=np.int64)
    fw = np.asarray([f[1] for f in finals], dtype=np.float32)
    src = np.asarray(g.arc_src, dtype=np.int32)
    dst = np.asarray(g.arc_dst, dtype=np.int32)
    il = np.asarray(g.arc_ilabel, dtype=np.int32)
    ol = np.asarray(g.arc_olabel, dtype=np.int32)
    w = np.asarray(g.arc_weight, dtype=np.float32)
    h = lib.tw_graph_new(
        len(start), start.ctypes.data, fnode.ctypes.data, fw.ctypes.data,
        len(fnode), len(src), src.ctypes.data, dst.ctypes.data, il.ctypes.data,
        ol.ctypes.data, w.ctypes.data,
    )
    handle = _Handle(lib, h)
    if warm:
        lib.tw_graph_warm(h)
    return handle


def compile_alignment(lexicon_handle, tokens_handle, transitions_handle, target):
    """The whole per-target transducer pipeline in one native call.

    Returns the fields of ``wfst.compile.CompiledGraph`` (numpy arrays)
    plus the transitions-arc provenance ``widx`` / ``eps_widx``."""
    lib = load_library()
    tgt = np.asarray(target, dtype=np.int32)
    th = transitions_handle.h if transitions_handle is not None else None
    h = lib.tw_compile_alignment(
        lexicon_handle.h, tokens_handle.h, th, tgt.ctypes.data, len(tgt)
    )
    if not h:
        raise ValueError("native alignment pipeline failed (epsilon cycle?)")
    try:
        sizes = np.zeros(4, dtype=np.int64)
        lib.tw_tables_sizes(h, sizes.ctypes.data)
        A, E, S, depth = (int(x) for x in sizes)
        src = np.zeros(A, np.int32)
        dst = np.zeros(A, np.int32)
        label = np.zeros(A, np.int32)
        weight = np.zeros(A, np.float32)
        widx = np.zeros(A, np.int64)
        start = np.zeros(S, np.float32)
        accept = np.zeros(S, np.float32)
        eps_src = np.zeros(E, np.int32)
        eps_dst = np.zeros(E, np.int32)
        eps_weight = np.zeros(E, np.float32)
        eps_widx = np.zeros(E, np.int64)
        lib.tw_tables_export(
            h, src.ctypes.data, dst.ctypes.data, label.ctypes.data,
            weight.ctypes.data, widx.ctypes.data, start.ctypes.data,
            accept.ctypes.data, eps_src.ctypes.data, eps_dst.ctypes.data,
            eps_weight.ctypes.data, eps_widx.ctypes.data,
        )
    finally:
        lib.tw_tables_free(h)
    return {
        "src": src, "dst": dst, "label": label, "weight": weight,
        "widx": widx.astype(np.int32),
        "start": start, "accept": accept,
        "eps_src": eps_src, "eps_dst": eps_dst, "eps_weight": eps_weight,
        "eps_widx": eps_widx.astype(np.int32),
        "eps_depth": depth,
    }
