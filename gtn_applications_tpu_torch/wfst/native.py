"""ctypes bindings to the native (C++) graph compiler, for the Transducer.

Counterpart of the parts of ``gtn_applications_tpu/wfst/native.py`` that
the port calls: loading ``native/libtwgraph.so``, ``to_native`` and
``from_native``, epsilon removal (``remove``, for
``compile.compile_acceptor(remove_eps=True)``), the one-call per-target
pipeline ``compile_alignment``, the forced-blank decode cleanup
``forced_collapse``, and the FLAC decoder ``decode_flac`` (``native/flac.cc``,
for ``datasets.audio.load_audio``).
Both packages share the library; its source is ``native/graph_compiler.cc``
at the root of the checkout.  The ``.so`` is not committed: the first call
builds it with ``make -C native`` (g++), under a file lock in ``build/``
so that concurrent processes build it once.  If it cannot be built, the call
raises and says how to build it; there is no pure-Python fallback in the
port (JAX's ``wfst/ops.py``, the graph operations in Python, is not
ported).
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
        for fn in ("tw_num_nodes", "tw_num_arcs", "tw_num_finals"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.tw_export.argtypes = [ctypes.c_void_p] * 9
        lib.tw_remove.restype = ctypes.c_void_p
        lib.tw_remove.argtypes = [ctypes.c_void_p]
        lib.tw_forced_collapse.restype = ctypes.c_int64
        lib.tw_forced_collapse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        _LIB = lib
        return lib


def available():
    """Whether the native library loads (building it if needed)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _bind_flac(lib):
    if getattr(lib, "_flac_bound", False):
        return
    lib.tw_flac_decode_alloc.restype = ctypes.POINTER(ctypes.c_int32)
    lib.tw_flac_decode_alloc.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tw_flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib._flac_bound = True


def decode_flac(data: bytes):
    """Decode a FLAC stream (``native/flac.cc``) to PCM.

    Returns ``(samples, sample_rate, bits_per_sample)``, samples an int32
    array of shape [frames, channels].  Raises ValueError on malformed
    input and RuntimeError where the native library cannot be built.
    """
    lib = load_library()
    _bind_flac(lib)
    info = np.zeros(4, dtype=np.int64)
    ptr = lib.tw_flac_decode_alloc(
        data, len(data), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if not ptr:
        raise ValueError("malformed or unsupported FLAC stream")
    try:
        frames, channels = int(info[3]), int(info[1])
        samples = np.ctypeslib.as_array(ptr, shape=(frames * channels,))
        samples = samples.reshape(frames, channels).copy()
    finally:
        lib.tw_flac_free(ptr)
    return samples, int(info[0]), int(info[2])


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


def from_native(handle: _Handle) -> Graph:
    """The ``Graph`` a native handle holds."""
    lib = handle.lib
    n = lib.tw_num_nodes(handle.h)
    a = lib.tw_num_arcs(handle.h)
    nf = lib.tw_num_finals(handle.h)
    start = np.zeros(n, dtype=np.uint8)
    fnode = np.zeros(nf, dtype=np.int64)
    fw = np.zeros(nf, dtype=np.float32)
    src, dst, il, ol = (np.zeros(a, dtype=np.int32) for _ in range(4))
    w = np.zeros(a, dtype=np.float32)
    lib.tw_export(handle.h, start.ctypes.data, fnode.ctypes.data, fw.ctypes.data,
                  src.ctypes.data, dst.ctypes.data, il.ctypes.data, ol.ctypes.data,
                  w.ctypes.data)
    g = Graph()
    for i in range(n):
        g.add_node(bool(start[i]), False)
    for node, weight in zip(fnode, fw):
        g.add_final(int(node), float(weight))
    g.arc_src = src.astype(int).tolist()
    g.arc_dst = dst.astype(int).tolist()
    g.arc_ilabel = il.astype(int).tolist()
    g.arc_olabel = ol.astype(int).tolist()
    g.arc_weight = w.astype(float).tolist()
    return g


def remove(g: Graph) -> Graph:
    """``g`` with its epsilon arcs removed, path weights and multiplicity
    kept (the native ``remove``)."""
    lib = load_library()
    h = to_native(g)
    hr = lib.tw_remove(h.h)
    if not hr:
        raise ValueError("epsilon cycle or explosion in native remove()")
    return from_native(_Handle(lib, hr))


def forced_collapse(paths, blank_idx, lengths=None):
    """The forced-blank Transducer's decode cleanup in one native call:
    collapse each alignment's runs and keep its tokens if the forced token
    graph accepts it (blank runs around and between every token run), else
    decode it to nothing.  paths [B, T] int (negative labels are dead
    frames), lengths [B] or None.  Returns a list of B int32 arrays."""
    lib = load_library()
    paths = np.ascontiguousarray(paths, dtype=np.int32)
    B, T = paths.shape
    cap = max(B * T, 1)
    out = np.zeros(cap, dtype=np.int32)
    counts = np.zeros(B, dtype=np.int64)
    lens = None if lengths is None else np.ascontiguousarray(lengths, dtype=np.int32)
    n = lib.tw_forced_collapse(
        paths.ctypes.data, B, T, None if lens is None else lens.ctypes.data,
        int(blank_idx), out.ctypes.data, cap, counts.ctypes.data)
    if n < 0:
        raise RuntimeError("forced_collapse: the output buffer overflowed")
    ends = np.cumsum(counts)
    return [out[e - c:e].copy() for e, c in zip(ends, counts)]


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
