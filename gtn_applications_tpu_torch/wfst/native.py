"""ctypes bindings to the native (C++) graph compiler.

Counterpart of the parts of ``gtn_applications_tpu/wfst/native.py`` that
the port calls: loading ``native/libtwgraph.so``, ``to_native`` and
``from_native``; the graph operations ``compose`` (with arc provenance),
``remove``, ``trim``, ``project``, ``forward_score`` and ``viterbi_score``
(``wfst.ops`` dispatches to them); the one-call per-target pipeline
``compile_alignment``; the decode cleanups ``forced_collapse`` (the
forced-blank Transducer) and ``asg_collapse`` (ASG); the six batched graph
engines (``ctc_engine_batch``, ``asg_engine_batch``,
``transducer_engine_batch``, ``transducer_viterbi_batch``,
``transducer_ngram_engine_batch``, ``acceptor_engine_batch``: the
reference's per-sample compose, forward score and graph autodiff on a host
thread pool, numpy in and out, bench denominators and differential
oracles, not a device path); the wordpiece
segmenter ``WordpieceEncoder`` and its E-step ``wordpiece_estep``
(``scripts/wordpiece.py``); ``edit_distance_i32``; and the FLAC decoder
``decode_flac`` (``native/flac.cc``, for ``datasets.audio.load_audio``).
Both packages share the library; its source is ``native/graph_compiler.cc``
at the root of the checkout.  The ``.so`` is not committed: the first call
builds it with ``make -C native`` (g++), under a file lock in ``build/``
so that concurrent processes build it once.  If it cannot be built, the call
raises and says how to build it.  Where JAX's callers fall back to Python
(``wfst.ops``, the wordpiece scripts, ASG's cleanup), the port's do so on
the same condition, ``enabled()``: the library loads and ``TW_NATIVE`` is
not ``0``.
"""

import ctypes
import fcntl
import os
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


def enabled():
    """Whether JAX's native routes are taken: the library loads and
    ``TW_NATIVE`` is not ``0`` (JAX's ``native.available()``)."""
    return os.environ.get("TW_NATIVE", "1") != "0" and available()


def _bind_ops(lib):
    if getattr(lib, "_ops_bound", False):
        return
    lib.tw_export_prov.argtypes = [ctypes.c_void_p] * 3
    lib.tw_compose.restype = ctypes.c_void_p
    lib.tw_compose.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.tw_trim.restype = ctypes.c_void_p
    lib.tw_trim.argtypes = [ctypes.c_void_p]
    lib.tw_project.restype = ctypes.c_void_p
    lib.tw_project.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for fn in ("tw_forward_score", "tw_viterbi_score"):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib._ops_bound = True


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


def _ops_library():
    lib = load_library()
    _bind_ops(lib)
    return lib


def compose(g1: Graph, g2: Graph, return_arc_map=False):
    """``wfst.ops.compose_py`` natively: the composed, trimmed graph and,
    with ``return_arc_map``, each arc's (g1 arc or -1, g2 arc or -1)."""
    lib = _ops_library()
    h1, h2 = to_native(g1), to_native(g2)
    hr = _Handle(lib, lib.tw_compose(h1.h, h2.h, 1 if return_arc_map else 0))
    out = from_native(hr)
    if not return_arc_map:
        return out
    a = lib.tw_num_arcs(hr.h)
    p1 = np.zeros(a, dtype=np.int64)
    p2 = np.zeros(a, dtype=np.int64)
    if a:
        lib.tw_export_prov(hr.h, p1.ctypes.data, p2.ctypes.data)
    return out, list(zip(p1.tolist(), p2.tolist()))


def trim(g: Graph) -> Graph:
    """``wfst.ops.trim`` natively: the states on a start-to-accept path."""
    lib = _ops_library()
    h = to_native(g)
    return from_native(_Handle(lib, lib.tw_trim(h.h)))


def project(g: Graph, input_side=True) -> Graph:
    """``wfst.ops.project_input`` (``input_side``) or ``project_output``
    natively."""
    lib = _ops_library()
    h = to_native(g)
    return from_native(_Handle(lib, lib.tw_project(h.h, 1 if input_side else 0)))


def _score(g, fn, what):
    lib = _ops_library()
    h = to_native(g)
    s = getattr(lib, fn)(h.h)
    if np.isnan(s):
        raise ValueError(f"graph has cycles; {what} requires a DAG")
    return float(s)


def forward_score(g: Graph) -> float:
    """``wfst.ops.forward_score_py`` natively (log semiring)."""
    return _score(g, "tw_forward_score", "forward_score")


def viterbi_score(g: Graph) -> float:
    """``wfst.ops.viterbi_score_py`` natively (tropical semiring)."""
    return _score(g, "tw_viterbi_score", "viterbi_score")


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


def _bind_engines(lib):
    if getattr(lib, "_engines_bound", False):
        return
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    for fn, args in (
        ("tw_ctc_engine_batch", [i64] * 3 + [vp] * 3 + [i64, ctypes.c_int32] + [vp] * 2),
        ("tw_asg_engine_batch", [i64] * 3 + [vp] * 3 + [i64] + [vp] * 4),
        ("tw_transducer_engine_batch", [i64] * 3 + [vp] * 5 + [i64] + [vp] * 2),
        ("tw_transducer_viterbi_batch", [i64] * 3 + [vp] * 3 + [i64]),
        ("tw_transducer_ngram_engine_batch", [i64] * 3 + [vp] * 6 + [i64] + [vp] * 3),
        ("tw_acceptor_engine_batch", [i64] * 3 + [vp] * 4),
    ):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = args
    lib._engines_bound = True


def _engine_log_probs(log_probs):
    """(the engines' library, contiguous float32 log_probs [B, T, C], B,
    T, C)."""
    lib = load_library()
    _bind_engines(lib)
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    return (lib, lp) + lp.shape


def _engine_targets(targets):
    """(int32 targets zero-padded to [B, max(1, L)], int64 lengths,
    max(1, L))."""
    lens = np.array([len(t) for t in targets], dtype=np.int64)
    lmax = max(1, int(lens.max()) if len(targets) else 1)
    tg = np.zeros((len(targets), lmax), dtype=np.int32)
    for b, t in enumerate(targets):
        tg[b, : len(t)] = t
    return tg, lens, lmax


def _check_fails(fails, what):
    if fails:
        raise ValueError(f"{fails} samples had no accepting {what}path")


def ctc_engine_batch(log_probs, targets, blank):
    """Graph-engine CTC forward and backward over a batch on the host: per
    sample the emission graph composed with the CTC acceptor, its log
    forward score and graph autodiff (reference ``criterions/ctc.py``),
    a thread pool over the batch.

    log_probs [B, T, C]; targets: lists of label ids; blank: the blank id.
    Returns (losses [B], grad [B, T, C]): losses[b] = -log p(target_b),
    grad = d losses / d log_probs (no batch reduction).  Raises ValueError
    where a sample has no accepting path."""
    lib, lp, B, T, C = _engine_log_probs(log_probs)
    tg, lens, lmax = _engine_targets(targets)
    losses = np.zeros(B, dtype=np.float32)
    grad = np.zeros((B, T, C), dtype=np.float32)
    fails = lib.tw_ctc_engine_batch(B, T, C, lp.ctypes.data, tg.ctypes.data,
                                    lens.ctypes.data, lmax, int(blank),
                                    losses.ctypes.data, grad.ctypes.data)
    _check_fails(fails, "CTC ")
    return losses, grad


def asg_engine_batch(log_probs, targets, transitions):
    """Graph-engine ASG forward and backward over a batch on the host
    (reference ``criterions/asg.py``: the free and force-aligned graphs'
    log forward scores, graph autodiff).

    log_probs [B, T, C]; targets: prepared id lists (replabels and garbage
    applied); transitions [(C + 1), C].  Returns (losses [B], grad_em
    [B, T, C], grad_trans [(C + 1), C] summed over the batch), losses[b] =
    logZ_free - logZ_forced."""
    lib, lp, B, T, C = _engine_log_probs(log_probs)
    tg, lens, lmax = _engine_targets(targets)
    tw = np.ascontiguousarray(transitions, dtype=np.float32)
    if tw.shape != (C + 1, C):
        raise ValueError(f"transitions {tw.shape}, expected {(C + 1, C)}")
    losses = np.zeros(B, dtype=np.float32)
    grad_em = np.zeros((B, T, C), dtype=np.float32)
    grad_trans = np.zeros((C + 1, C), dtype=np.float32)
    fails = lib.tw_asg_engine_batch(B, T, C, lp.ctypes.data, tg.ctypes.data,
                                    lens.ctypes.data, lmax, tw.ctypes.data,
                                    losses.ctypes.data, grad_em.ctypes.data,
                                    grad_trans.ctypes.data)
    _check_fails(fails, "ASG ")
    return losses, grad_em, grad_trans


def transducer_engine_batch(log_probs, lexicon, tokens, targets):
    """Graph-engine Transducer forward and backward without transitions on
    the host: per sample -forward_score(emissions o alignment graph of the
    target), the decompositions marginalised through the lexicon.

    log_probs [B, T, C]; lexicon, tokens: the criterion's host ``Graph``s;
    targets: grapheme id lists.  Returns (losses [B], grad [B, T, C])."""
    lib, lp, B, T, C = _engine_log_probs(log_probs)
    tg, lens, lmax = _engine_targets(targets)
    hl = to_native(lexicon, warm=True)
    ht = to_native(tokens, warm=True)
    losses = np.zeros(B, dtype=np.float32)
    grad = np.zeros((B, T, C), dtype=np.float32)
    fails = lib.tw_transducer_engine_batch(B, T, C, lp.ctypes.data, hl.h, ht.h,
                                           tg.ctypes.data, lens.ctypes.data, lmax,
                                           losses.ctypes.data, grad.ctypes.data)
    _check_fails(fails, "alignment ")
    return losses, grad


def transducer_viterbi_batch(log_probs, tokens, cap=None):
    """Graph-engine Transducer decode without transitions on the host: per
    sample the best path through the emissions, composed with the token
    graph, its best path projected on the output, epsilons dropped.

    log_probs [B, T, C]; tokens: the criterion's host ``Graph``; cap: most
    labels a sample (default T).  Returns B lists of token ids."""
    lib, lp, B, T, C = _engine_log_probs(log_probs)
    ht = to_native(tokens, warm=True)
    cap = int(cap or max(T, 1))
    out = np.full((B, cap), -1, dtype=np.int32)
    fails = lib.tw_transducer_viterbi_batch(B, T, C, lp.ctypes.data, ht.h,
                                            out.ctypes.data, cap)
    _check_fails(fails, "decode ")
    return [[int(v) for v in row[row >= 0]] for row in out]


def transducer_ngram_engine_batch(log_probs, lexicon, tokens, transitions, targets):
    """Graph-engine Transducer forward and backward with a transition
    graph on the host: per sample logZ(em o trans) - logZ(em o (trans o
    alignment graph)), with graph autodiff of the emissions and of the
    transitions' arc weights.

    log_probs [B, T, C]; lexicon, tokens, transitions: the criterion's host
    ``Graph``s; targets: grapheme id lists.  Returns (losses [B], grad_em
    [B, T, C], grad_trans [transition arcs], summed over the batch)."""
    lib, lp, B, T, C = _engine_log_probs(log_probs)
    tg, lens, lmax = _engine_targets(targets)
    hl = to_native(lexicon, warm=True)
    ht = to_native(tokens, warm=True)
    htr = to_native(transitions, warm=True)
    losses = np.zeros(B, dtype=np.float32)
    grad_em = np.zeros((B, T, C), dtype=np.float32)
    grad_trans = np.zeros(transitions.num_arcs(), dtype=np.float32)
    fails = lib.tw_transducer_ngram_engine_batch(
        B, T, C, lp.ctypes.data, hl.h, ht.h, htr.h, tg.ctypes.data, lens.ctypes.data,
        lmax, losses.ctypes.data, grad_em.ctypes.data, grad_trans.ctypes.data)
    _check_fails(fails, "ngram ")
    return losses, grad_em, grad_trans


def acceptor_engine_batch(log_probs, graphs):
    """Graph-engine forward and backward of per-sample acceptors on the
    host: losses[b] = -logZ(em_b o graphs[b]) (STC's star graphs, built a
    batch).  Returns (losses [B], grad [B, T, C])."""
    lib, lp, B, T, C = _engine_log_probs(log_probs)
    handles = [to_native(g) for g in graphs]  # alive until the call returns
    harr = (ctypes.c_void_p * B)(*[h.h for h in handles])
    losses = np.zeros(B, dtype=np.float32)
    grad = np.zeros((B, T, C), dtype=np.float32)
    fails = lib.tw_acceptor_engine_batch(B, T, C, lp.ctypes.data,
                                         ctypes.addressof(harr), losses.ctypes.data,
                                         grad.ctypes.data)
    del handles
    _check_fails(fails, "")
    return losses, grad


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


def asg_collapse(paths, lengths=None, garbage_idx=None, num_replabels=0):
    """ASG's decode cleanup in one native call: collapse each path's runs,
    drop the garbage label, unpack the replabels.  paths [B, T] int,
    lengths [B] or None.  Returns a list of B int32 arrays."""
    lib = load_library()
    if not getattr(lib, "_asg_bound", False):
        lib.tw_asg_collapse.restype = ctypes.c_int64
        lib.tw_asg_collapse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib._asg_bound = True
    paths = np.ascontiguousarray(paths, dtype=np.int32)
    B, T = paths.shape
    cap = max(B * T * (num_replabels + 1), 1)
    out = np.zeros(cap, dtype=np.int32)
    counts = np.zeros(B, dtype=np.int64)
    lens = None if lengths is None else np.ascontiguousarray(lengths, dtype=np.int32)
    n = lib.tw_asg_collapse(
        paths.ctypes.data, B, T, None if lens is None else lens.ctypes.data,
        -1 if garbage_idx is None else int(garbage_idx), int(num_replabels),
        out.ctypes.data, cap, counts.ctypes.data)
    if n < 0:
        raise RuntimeError("asg_collapse: the output buffer overflowed")
    ends = np.cumsum(counts)
    return [out[e - c:e].copy() for e, c in zip(ends, counts)]


def edit_distance_i32(a, b):
    """Levenshtein distance between two int32 sequences, natively."""
    lib = load_library()
    if not getattr(lib, "_ed_bound", False):
        lib.tw_edit_distance.restype = ctypes.c_int64
        lib.tw_edit_distance.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._ed_bound = True
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    return int(lib.tw_edit_distance(a.ctypes.data, len(a), b.ctypes.data, len(b)))


def _bind_wordpiece(lib):
    if getattr(lib, "_wp_bound", False):
        return
    lib.tw_wp_model_new.restype = ctypes.c_void_p
    lib.tw_wp_model_new.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.tw_wp_model_free.argtypes = [ctypes.c_void_p]
    lib.tw_wp_encode.restype = ctypes.c_int64
    lib.tw_wp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.tw_wp_encode_batch.restype = ctypes.c_int64
    lib.tw_wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tw_wp_estep.restype = ctypes.c_double
    lib.tw_wp_estep.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib._wp_bound = True


def _unknown_char(data, v):
    """The UTF-8 character at byte offset -1 - v of ``data`` (the
    segmenter's code for a character no piece covers)."""
    off = -1 - int(v)
    end = off + 1
    while end < len(data) and (data[end] & 0xC0) == 0x80:
        end += 1
    return data[off:end].decode("utf-8")


class WordpieceEncoder:
    """Native unigram Viterbi segmenter, with ``scripts.wordpiece``'s
    ``UnigramModel`` semantics: a DP over code points, ties to the longest
    piece, a character no piece covers kept at log-probability -100."""

    def __init__(self, pieces, log_probs):
        lib = load_library()
        _bind_wordpiece(lib)
        self.lib = lib
        self.pieces = list(pieces)
        arr = (ctypes.c_char_p * len(self.pieces))(
            *[p.encode("utf-8") for p in self.pieces])
        lp = np.ascontiguousarray(log_probs, dtype=np.float32)
        self.h = lib.tw_wp_model_new(arr, lp.ctypes.data, len(self.pieces))
        self._buf = np.zeros(4096, dtype=np.int32)

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.tw_wp_model_free(self.h)
            self.h = None

    def encode(self, text):
        """``text`` segmented into a list of pieces."""
        data = text.encode("utf-8")
        n = self.lib.tw_wp_encode(self.h, data, len(data), self._buf.ctypes.data,
                                  len(self._buf))
        if n == -1:  # the buffer is too small
            self._buf = np.zeros(len(self._buf) * 4, dtype=np.int32)
            return self.encode(text)
        if n < 0:
            raise ValueError("wordpiece encode failed")
        return [self.pieces[v] if v >= 0 else _unknown_char(data, v)
                for v in self._buf[:n].tolist()]

    def encode_batch(self, texts):
        """Each of ``texts`` segmented, in one native call."""
        datas = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum([len(d) for d in datas], out=offsets[1:])
        cap = max(4096, sum(len(t) for t in texts) + len(texts))
        out = np.zeros(cap, dtype=np.int32)
        counts = np.zeros(len(texts), dtype=np.int64)
        n = self.lib.tw_wp_encode_batch(
            self.h, b"".join(datas), offsets.ctypes.data, len(texts),
            out.ctypes.data, cap, counts.ctypes.data)
        if n < 0:
            raise ValueError("wordpiece batch encode failed")
        ids = out[:int(n)].tolist()
        results, pos = [], 0
        for d, c in zip(datas, counts.tolist()):
            results.append([self.pieces[v] if v >= 0 else _unknown_char(d, v)
                            for v in ids[pos:pos + c]])
            pos += c
        return results


def wordpiece_estep(encoder: WordpieceEncoder, sentences):
    """Expected piece counts over all segmentations (forward-backward),
    natively.  Returns ({piece: count} for the pieces with a positive count,
    in the encoder's order; the total log-likelihood)."""
    lib = encoder.lib
    data = bytearray()
    offsets = np.zeros(len(sentences) + 1, dtype=np.int64)
    for i, s in enumerate(sentences):
        data.extend(s.encode("utf-8"))
        offsets[i + 1] = len(data)
    expected = np.zeros(len(encoder.pieces), dtype=np.float64)
    ll = lib.tw_wp_estep(encoder.h, bytes(data), offsets.ctypes.data,
                         len(sentences), expected.ctypes.data)
    counts = {p: float(c) for p, c in zip(encoder.pieces, expected) if c > 0.0}
    return counts, float(ll)
