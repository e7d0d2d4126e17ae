"""Viterbi decoding kernels: the dense backtrace and the whole-scan
tropical decode over a bucketed arc table.

Counterpart of ``dense_backtrace``, ``build_plan`` and ``viterbi_scan`` in
``gtn_applications_tpu/ops/viterbi_scan_pallas.py`` (Pallas kernels
``_dense_bt_kernel``, ``_vit_kernel`` and ``_backtrace_kernel``).  The
module keeps the JAX file's name; the kernels are CUDA C++ for Hopper
(``csrc/viterbi.cu``).

Layouts: dense backpointers are ``[B, T-1, C]`` (sample-major, so one
sample's table is one contiguous slice), where JAX takes ``[T-1, B, C]``.
The whole scan's plan is a ``[D, S]`` in-degree bucket grid (slot ``d`` of
destination state ``s``, filled in increasing arc id, empty slots at
weight NEG) without the TPU's 128-lane padding of S; its backpointers are
int32 slots ``[B, T, S]`` with ``DEAD`` = 2^30 for frames past the input
length and for states that no live arc reaches.

The scan's kernel reads the plan as a list by destination
(``pack_buckets``): each state's slots up to its last real one, in
increasing d, packed in 8 bytes (source | label << 16, weight), so a
position less its row's start is the slot; trailing slots of weight <= NEG
are not arcs (they contribute at most NEG, which never makes a slot).
Beside it a lane schedule (``lane_schedule``) gives each state a group of
lanes by its in-degree.  Both are built on the host once per plan
(``Plan.packed``); the [D, S] buckets stay for the plain versions.  The
kernel runs one block a sample, its arcs held in registers, shared or
global memory (``scan_route``), the sample's emission rows all staged or
passing through a ring (``scan_rows``).  The decode's backtrace is the
tail of the same launch: each frame also writes its winning arcs' packed
words (source | label << 16; a DEAD slot's is the state | 0xffff << 16),
kept in shared memory where a sample's fit (``walk_route`` "shared"), else
in a global scratch read back by chunks (``walk_route`` "chunked"), and one
thread walks them from the best final state, one word a frame.
"""

import collections
from dataclasses import dataclass, field
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build
from .semiring import NEG

DEAD = 2**30  # slot sentinel: unreachable state / frame past the length
# the dense bucket layout may blow A up to D_max * S; beyond this ratio the
# padding waste is refused (JAX's gate, on the unpadded state count)
_MAX_BLOWUP = 16


def dense_backtrace_plain(backptrs, last_state):
    """The take_along_axis walk: path[:, T-1] = last_state and
    path[:, t] = backptrs[:, t, path[:, t+1]]."""
    B, Tm1, _ = backptrs.shape
    state = last_state.long()
    path = [state]
    for t in reversed(range(Tm1)):
        state = torch.gather(backptrs[:, t].long(), 1, state[:, None])[:, 0]
        path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


# the dense backtrace's ring; must match csrc/viterbi.cu
BT_RING = 3  # chunks in shared memory
BT_CHUNK_WORDS = 4096  # a chunk's words at most, where kBtRing fit


def dense_bt_plan(T, C, max_smem=_build.MAX_SMEM):
    """(frames, ring, chunks) of the ``dense_backtrace`` kernel for a
    [T-1, C] table: a ring of BT_RING chunks of ``frames`` frames each
    (about BT_CHUNK_WORDS / C, at most T - 1, fewer where BT_RING slots of
    round4(frames C + 3) words would not fit in ``max_smem`` bytes), walked
    from the last frame back; frames 0 where BT_RING chunks of one frame
    do not fit, and the table is walked from global memory."""
    cap = (max_smem // (4 * BT_RING)) & ~3
    most = (cap - 3) // C
    if most < 1:
        return 0, BT_RING, 0
    frames = min(max(1, BT_CHUNK_WORDS // C), most, T - 1)
    return frames, BT_RING, -(-(T - 1) // frames)


def dense_backtrace_cuda(backptrs, last_state):
    """Launch ``dense_backtrace``: backptrs [B, T-1, C] int32 (T >= 2),
    last_state [B] int32 -> path [B, T] int32."""
    _build.require_cuda("dense_backtrace", backptrs, last_state)
    B, Tm1, C = backptrs.shape
    _build.require("dense_backtrace backptrs", backptrs, (B, Tm1, C), torch.int32)
    _build.require("dense_backtrace last_state", last_state, (B,), torch.int32)
    if Tm1 < 1:
        raise ValueError("dense_backtrace_cuda needs T >= 2 frames")
    path = torch.empty((B, Tm1 + 1), dtype=torch.int32, device=backptrs.device)
    lib = _build.load_library("viterbi")
    with torch.cuda.device(backptrs.device):
        err = lib.dense_backtrace(
            backptrs.data_ptr(), last_state.data_ptr(), path.data_ptr(),
            B, Tm1 + 1, C, _build.MAX_SMEM, _build.stream_handle(backptrs),
        )
    _build.check(lib, err, "dense_backtrace")
    _build.LAUNCHES["dense_bt"] += 1
    return path


def dense_backtrace(backptrs, last_state):
    """Walk dense prev-state backpointers to a path.

    Args:
      backptrs: [B, T-1, C] int — the previous state entering each frame
        (the identity at frames past a sample's input length).
      last_state: [B] int — the best state at the final frame.
    Returns path [B, T] int32.  With T == 1 the path is ``last_state``.
    """
    last_state = last_state.to(torch.int32)
    if backptrs.shape[1] == 0:
        return last_state[:, None]
    if _build.on_cuda(backptrs):
        return dense_backtrace_cuda(
            backptrs.to(torch.int32).contiguous(), last_state.contiguous()
        )
    return dense_backtrace_plain(backptrs, last_state)


# ---------------------------------------------------------------------
# Whole-scan Viterbi over a bucketed arc table
# ---------------------------------------------------------------------


@dataclass
class Plan:
    """Dense in-degree bucket layout of a shared epsilon-free arc table:
    CPU tensors ``src_bucket`` / ``label_bucket`` [D, S] int32,
    ``w_bucket`` [D, S] float32, ``start`` / ``accept`` [S] float32, and
    their copies on each device that decoded with them."""

    src_bucket: torch.Tensor
    label_bucket: torch.Tensor
    w_bucket: torch.Tensor
    start: torch.Tensor
    accept: torch.Tensor
    table_ref: object
    on_device: Dict = field(default_factory=dict)
    packed_on: Dict = field(default_factory=dict)

    @property
    def D(self):
        return self.src_bucket.shape[0]

    @property
    def S(self):
        return self.src_bucket.shape[1]

    def to(self, device):
        """(src_bucket, label_bucket, w_bucket, start, accept) on
        ``device``, copied once per device."""
        key = str(device)
        if key not in self.on_device:
            self.on_device[key] = tuple(
                t.to(device) for t in (self.src_bucket, self.label_bucket,
                                       self.w_bucket, self.start, self.accept))
        return self.on_device[key]

    def packed(self, device, cap=None):
        """The scan kernel's ``Packed`` list and lane schedule on
        ``device``, built on the host once per plan (and ``cap``)."""
        key = (str(device), cap)
        if key not in self.packed_on:
            host = self.packed_on.get(("cpu", cap))
            if host is None:
                host = pack_buckets(self.src_bucket, self.label_bucket,
                                    self.w_bucket, cap)
            self.packed_on[key] = host.to(device)
        return self.packed_on[key]


_PLAN_CACHE = collections.OrderedDict()
_PLAN_CACHE_MAX = 8
_PLAN_FIELDS = ("src", "dst", "label", "weight", "start", "accept")


def build_plan(table):
    """Bucket ``table``'s arcs by destination into a [D, S] slot grid.

    Returns a cached ``Plan`` (keyed by the identity of the table's
    fields) or None when the dense layout's blow-up exceeds the gate.
    """
    key = id(table.src)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and all(
        getattr(hit.table_ref, f) is getattr(table, f) for f in _PLAN_FIELDS
    ):
        _PLAN_CACHE.move_to_end(key)
        return hit

    src, dst, label, weight, start, accept = (
        np.asarray(getattr(table, f)) for f in _PLAN_FIELDS)
    A = src.shape[0]
    S = start.shape[0]
    # drop padding arcs (weight NEG) before computing the degree bound
    real = weight > NEG / 2
    src, dst, label, weight = src[real], dst[real], label[real], weight[real]
    if src.size == 0:
        return None
    deg = np.bincount(dst, minlength=S)
    D = int(deg.max())
    if D * S > max(_MAX_BLOWUP * A, 8 * S):
        return None

    src_b = np.zeros((D * S,), np.int32)
    label_b = np.zeros((D * S,), np.int32)
    w_b = np.full((D * S,), NEG, np.float32)
    # increasing-arc-id fill per destination => lowest slot == lowest arc id
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    _, first = np.unique(sorted_dst, return_index=True)
    group_sizes = np.diff(np.append(first, len(sorted_dst)))
    d_sorted = np.arange(len(sorted_dst)) - np.repeat(first, group_sizes)
    d_idx = np.empty((len(sorted_dst),), np.int64)
    d_idx[order] = d_sorted
    pos = d_idx * S + dst
    src_b[pos] = src
    label_b[pos] = label
    w_b[pos] = weight

    as_t = torch.from_numpy
    plan = Plan(
        src_bucket=as_t(src_b.reshape(D, S)),
        label_bucket=as_t(label_b.reshape(D, S)),
        w_bucket=as_t(w_b.reshape(D, S)),
        start=as_t(np.array(start, np.float32)),
        accept=as_t(np.array(accept, np.float32)),
        table_ref=table,
    )
    _PLAN_CACHE[key] = plan
    if len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return plan


# ---------------------------------------------------------------------
# The scan kernel's list by destination and lane schedule
# ---------------------------------------------------------------------

# Must match csrc/viterbi.cu: a lane holds at most LANE_ARCS arcs and runs
# that many rounds, the emission rows pass through a ring of RING rows
# where a sample's rows do not all fit, a block has at most MAX_WARPS
# warps; HEAD words start the schedule.
LANE_ARCS = 12
RING = 8
MAX_WARPS = 24
WARP = 32
HEAD = 10
ROUTES = ("registers", "shared", "global")
# The walk's routes (``walk_route``), its chunks' frames (route "chunked")
# and the label half of a DEAD slot's walk word
WALKS = ("shared", "chunked")
WALK_CHUNK = 32
DEAD_LABEL = 0xFFFF


class Packed(NamedTuple):
    """A plan's arcs by destination and lane schedule, as the scan kernel
    reads them.  ``arcs [A + 1, 2]`` int32: (source | label << 16, the
    weight's float32 bits), state by state, each row's slots in increasing
    d; the last is a pad arc (0, -inf).  ``sched`` int32: ``lane_schedule``'s
    words.  ``S``: the states; ``labels``: 1 + the largest label (the
    emission rows must be that wide); ``slots``, ``hubs``, ``chunks``: the
    schedule's counts; ``cap``: the most arcs a lane holds."""

    arcs: torch.Tensor
    sched: torch.Tensor
    S: int
    labels: int
    A: int
    slots: int
    hubs: int
    chunks: int
    cap: int

    def to(self, device):
        return self._replace(arcs=self.arcs.to(device), sched=self.sched.to(device))


def _widths(n, cap):
    """(lanes of each row's group, hub rows): the smallest power of two g
    with ceil(n / g) <= cap; a row of more than WARP cap arcs is a hub, a
    warp per chunk of WARP cap arcs."""
    need = np.maximum(1, -(-n // cap))
    g = np.ones(n.shape, np.int64)
    while (g < np.minimum(need, WARP)).any():
        g = np.where(g < np.minimum(need, WARP), 2 * g, g)
    return g, need > WARP


def lane_schedule(n, cap):
    """The scan kernel's lane schedule for rows (states) of ``n [S]`` arcs,
    laid out one after another in the list by destination, each lane
    holding at most ``cap`` arcs.  Row s gets a group of g lanes
    (``_widths``); lane sub of the group takes the row's arcs sub, sub + g,
    ...  A hub row is cut into chunks of WARP cap arcs, a warp each, whose
    (value, slot) pairs go to parts merged after a barrier.  A row of no
    arcs takes no lane: it is NEG with slot DEAD in every frame.  Tasks
    (rows and chunks) come widest first, then longest first; a slot holds
    WARP / g tasks of one width g and runs on one warp.

    Returns int32 words: HEAD words (slots, tasks, hubs, chunks, slot
    offset, task offset, hub offset, cap, empty rows, their offset), then
    3 a slot (g, first task, tasks), 4 a task (key: the state, or -1 - p
    for a hub chunk into part p; position of its first arc; arcs; the slot
    d of its first arc), 3 a hub (state, first part, parts), 1 an empty
    row (its state)."""
    if not 1 <= cap <= LANE_ARCS:
        raise ValueError(f"lane_schedule: cap {cap} is not in [1, {LANE_ARCS}]")
    n = np.asarray(n, np.int64)
    ptr = np.cumsum(n) - n
    g, hub = _widths(n, cap)
    tasks = [(int(g[s]), s, int(ptr[s]), int(n[s]), 0)
             for s in np.flatnonzero(~hub & (n > 0))]
    hubs, span = [], WARP * cap
    for s in np.flatnonzero(hub):
        chunks = -(-int(n[s]) // span)
        p0 = len(hubs) and hubs[-1][1] + hubs[-1][2]
        hubs.append((int(s), p0, chunks))
        tasks += [(WARP, -1 - (p0 + i), int(ptr[s]) + i * span,
                   min(span, int(n[s]) - i * span), i * span) for i in range(chunks)]
    tasks.sort(key=lambda x: (-x[0], -x[3]))  # stable: rows, then chunks, in order
    slots, i = [], 0
    while i < len(tasks):
        w = tasks[i][0]
        j = i
        while j < len(tasks) and j - i < WARP // w and tasks[j][0] == w:
            j += 1
        slots.append((w, i, j - i))
        i = j
    task_off = HEAD + 3 * len(slots)
    hub_off = task_off + 4 * len(tasks)
    chunks = hubs[-1][1] + hubs[-1][2] if hubs else 0
    empty = np.flatnonzero(n == 0)
    words = [len(slots), len(tasks), len(hubs), chunks, HEAD, task_off, hub_off, cap,
             empty.size, hub_off + 3 * len(hubs)]
    for x in slots:
        words += x
    for x in tasks:
        words += x[1:]
    for x in hubs:
        words += x
    words += empty.tolist()
    return np.asarray(words, np.int32)


def pack_buckets(src_bucket, label_bucket, w_bucket, cap=None):
    """The ``Packed`` list by destination and lane schedule of [D, S]
    buckets (CPU tensors or any, copied to the host): row s holds slots
    d < n(s), n(s) = 1 + its last slot of weight > NEG.  ``cap``: the most
    arcs a lane holds (LANE_ARCS when None; a lane runs LANE_ARCS rounds
    all the same, so a smaller cap only widens the groups).  Raises for S
    or a label of 2^16 or more, and for a source outside [0, S) or a
    negative label."""
    src, lab, w = (x.detach().cpu().numpy() for x in (src_bucket, label_bucket, w_bucket))
    D, S = src.shape
    if S >= 2**16:
        raise ValueError(f"viterbi_scan: {S} states; the packed arcs take fewer than 2^16")
    real = w.astype(np.float32) > np.float32(NEG)
    n = np.where(real.any(0), D - np.argmax(real[::-1], axis=0), 0)
    rows = (np.arange(D)[:, None] < n[None, :]).T  # [S, D]: by state, then slot
    src, lab, w = src.T[rows], lab.T[rows], w.T[rows].astype(np.float32)
    if src.size and (src.min() < 0 or src.max() >= S or lab.min() < 0):
        raise ValueError("viterbi_scan: an arc's source lies outside [0, S) or its "
                         "label is negative")
    if src.size and lab.max() >= 2**16:
        raise ValueError("viterbi_scan: a label of 2^16 or more does not pack")
    A = src.size
    arcs = np.empty((A + 1, 2), np.int32)
    arcs[:A, 0] = (src.astype(np.uint32) | lab.astype(np.uint32) << 16).view(np.int32)
    arcs[:A, 1] = w.view(np.int32)
    arcs[A] = (0, np.float32(-np.inf).view(np.int32))
    cap = LANE_ARCS if cap is None else cap
    words = lane_schedule(n, cap)
    return Packed(torch.from_numpy(arcs), torch.from_numpy(words), S,
                  int(lab.max()) + 1 if A else 0, A, int(words[0]), int(words[2]),
                  int(words[3]), cap)


def _round4(n):
    return -(-n // 4) * 4


def walk_words(S, T, walk):
    """Shared memory of the decode's walk, in 4-byte words: the walk words
    (a sample's T S for ``walk`` "shared", two chunks of WALK_CHUNK frames
    of S padded to 4 for "chunked"), the T labels and the argmax's 64 words
    of scratch; 0 for the scan alone (``walk`` None)."""
    if walk is None:
        return 0
    rows = _round4(T * S) if walk == "shared" else 2 * WALK_CHUNK * _round4(S)
    return rows + _round4(T) + 2 * WARP


def smem_words(packed, S, C, route, rows=RING, walk=None, T=0):
    """Shared memory of a scan block, in 4-byte words: alpha by parity,
    ``rows`` emission rows and the hub parts (value, slot, word); route
    "shared" adds the arcs and the schedule, a decode over T frames its
    ``walk_words``."""
    words = 2 * S + rows * C + 3 * packed.chunks + walk_words(S, T, walk)
    if route == "shared":
        words += 2 * (packed.A + 1) + packed.sched.numel()
    return words


def route_fits(packed, S, C, route, walk=None, T=0):
    """Whether ``route`` can run this plan: "registers" needs one slot a
    warp of a block, "shared" the arcs and schedule in shared memory, any
    route the state, a ring of RING emission rows and the walk (``walk``,
    over T frames) in shared memory."""
    if route not in ROUTES:
        raise ValueError(f"viterbi_scan_fwd: route {route!r} is not one of {ROUTES}")
    if walk is not None and walk not in WALKS:
        raise ValueError(f"viterbi_scan_fwd: walk {walk!r} is not one of {WALKS}")
    if route == "registers" and packed.slots > MAX_WARPS:
        return False
    return 4 * smem_words(packed, S, C, route, RING, walk, T) <= _build.MAX_SMEM


def scan_route(packed, S, C, walk=None, T=0):
    """The scan's route: "registers" where the schedule fits one slot a
    warp, else "shared" where the arcs fit in shared memory, else
    "global"; beside ``walk`` over T frames (a decode) where given.  Raises
    where even the state does not fit."""
    for route in ROUTES:
        if route_fits(packed, S, C, route, walk, T):
            return route
    raise ValueError(f"viterbi_scan_fwd: the state of S={S} states and C={C} channels "
                     f"(walk {walk}, T={T}) does not fit in shared memory")


def walk_route(packed, S, T, C, route):
    """The decode's walk beside the scan's ``route``: "shared" where a
    sample's T S walk words fit in shared memory, else "chunked" (the words
    in a global scratch, walked by chunks of WALK_CHUNK frames copied into
    shared memory).  Raises where neither fits."""
    for walk in WALKS:
        if route_fits(packed, S, C, route, walk, T):
            return walk
    raise ValueError(f"viterbi_scan_fwd: no walk fits beside route {route} (S={S}, T={T}, "
                     f"C={C})")


def scan_rows(packed, S, T, C, route, walk=None):
    """The emission rows a block keeps: all T where they fit beside the
    route's state and tables and the ``walk`` (staged at the start: no copy
    during the frames), else a ring of RING filled ahead."""
    fits = 4 * smem_words(packed, S, C, route, T, walk, T) <= _build.MAX_SMEM
    return T if fits else RING


def viterbi_scan_fwd_plain(em, src_bucket, label_bucket, w_bucket, start,
                           lengths):
    """(slots [B, T, S] int32, final alpha [B, S]) of the tropical scan:
    contrib[d, s] = (alpha[src[d, s]] + w[d, s]) + em[t, label[d, s]], the
    best slot the lowest d attaining the maximum."""
    B, T, _ = em.shape
    S = start.shape[0]
    src, lab = src_bucket.long(), label_bucket.long()
    alpha = start[None, :].expand(B, S)
    lens = lengths.view(B, 1)
    slots = []
    for t in range(T):
        contrib = (alpha[:, src] + w_bucket) + em[:, t][:, lab]
        best, best_d = torch.max(contrib, dim=1)          # first max on ties
        best = torch.clamp(best, min=NEG)
        live = t < lens
        alpha = torch.where(live, best, alpha)
        slots.append(torch.where(live & (best > NEG), best_d.to(torch.int32),
                                 DEAD))
    return torch.stack(slots, dim=1), alpha.contiguous()


def viterbi_backtrace_plain(slots, final_alpha, accept, src_bucket,
                            label_bucket):
    """(labels [B, T] int32, score [B]): from the first argmax of
    final + accept, walk the slots back to frame 0 (label -1 and the state
    kept on a DEAD slot); infeasible samples (score <= NEG/2) give all -1."""
    B, T, S = slots.shape
    scored = final_alpha + accept[None, :]
    score, state = torch.max(scored, dim=1)
    labels = [None] * T
    for t in reversed(range(T)):
        d = torch.gather(slots[:, t], 1, state[:, None])[:, 0]
        valid = d < DEAD
        d = torch.where(valid, d, 0).long()
        labels[t] = torch.where(valid, label_bucket.long()[d, state], -1)
        state = torch.where(valid, src_bucket.long()[d, state], state)
    labels = torch.stack(labels, dim=1).to(torch.int32)
    return torch.where((score > NEG / 2)[:, None], labels, -1), score


def _plan_check(name, src_bucket, label_bucket, w_bucket=None, start=None):
    D, S = src_bucket.shape
    _build.require(f"{name} src_bucket", src_bucket, (D, S), torch.int32)
    _build.require(f"{name} label_bucket", label_bucket, (D, S), torch.int32)
    if w_bucket is not None:
        _build.require(f"{name} w_bucket", w_bucket, (D, S), torch.float32)
    if start is not None:
        _build.require(f"{name} start", start, (S,), torch.float32)
    return D, S


def viterbi_scan_fwd_cuda(em, src_bucket, label_bucket, w_bucket, start,
                          lengths, packed=None, route=None, accept=None, walk=None):
    """Launch ``viterbi_scan_fwd``: em [B, T, C] float32, the plan's
    [D, S] buckets and start [S], lengths [B] int32 -> (slots [B, T, S]
    int32, final alpha [B, S]); with ``accept`` [S] the decode, the walk in
    the same launch: -> (slots, final alpha, labels [B, T] int32, score
    [B]).  Every label must lie in [0, C).  ``packed``: the buckets'
    ``Packed`` on em's device (``Plan.packed``); built from them here (a
    copy to the host) when None.  ``route``: one of ``ROUTES``, ``walk``
    one of ``WALKS``, default ``scan_route``'s and ``walk_route``'s; a
    choice that does not fit raises."""
    _build.require_cuda("viterbi_scan_fwd", em, src_bucket, label_bucket,
                        w_bucket, start, lengths)
    B, T, C = em.shape
    _build.require("viterbi_scan_fwd em", em, (B, T, C), torch.float32)
    D, S = _plan_check("viterbi_scan_fwd", src_bucket, label_bucket, w_bucket,
                       start)
    _build.require("viterbi_scan_fwd lengths", lengths, (B,), torch.int32)
    if accept is None and walk is not None:
        raise ValueError("viterbi_scan_fwd: a walk needs accept")
    if accept is not None:
        _build.require_cuda("viterbi_scan_fwd", em, accept)
        _build.require("viterbi_scan_fwd accept", accept, (S,), torch.float32)
    if C >= 2**16:
        raise ValueError(f"viterbi_scan_fwd: {C} channels; the packed arcs take "
                         "fewer than 2^16")
    if packed is None:
        packed = pack_buckets(src_bucket, label_bucket, w_bucket).to(em.device)
    _build.require_cuda("viterbi_scan_fwd", em, packed.arcs, packed.sched)
    if packed.S != S or packed.labels > C:
        raise ValueError(f"viterbi_scan_fwd: the packed plan (S={packed.S}, labels up to "
                         f"{packed.labels - 1}) does not fit S={S}, C={C}")
    least = None if accept is None else WALKS[-1]  # the walk that takes least room
    if route is None:
        route = scan_route(packed, S, C, least, T)
    elif not route_fits(packed, S, C, route, least, T):
        raise ValueError(f"viterbi_scan_fwd: route {route} does not fit this plan "
                         f"({packed.slots} slots, {packed.A} arcs, S={S}, C={C}, T={T})")
    if accept is not None:
        if walk is None:
            walk = walk_route(packed, S, T, C, route)
        elif not route_fits(packed, S, C, route, walk, T):
            raise ValueError(f"viterbi_scan_fwd: walk {walk} does not fit beside route "
                             f"{route} (S={S}, T={T}, C={C})")
    threads = WARP * max(1, min(packed.slots, MAX_WARPS))
    rows = scan_rows(packed, S, T, C, route, walk)
    dev = em.device
    slots = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    final = torch.empty((B, S), dtype=torch.float32, device=dev)
    labels = score = words = None
    if accept is not None:
        labels = torch.empty((B, T), dtype=torch.int32, device=dev)
        score = torch.empty((B,), dtype=torch.float32, device=dev)
    if walk == "chunked":
        words = torch.empty((B, T, _round4(S)), dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _build.load_library("viterbi")
    with torch.cuda.device(dev):
        err = lib.viterbi_scan_fwd(
            em.data_ptr(), packed.arcs.data_ptr(), packed.sched.data_ptr(),
            start.data_ptr(), lengths.data_ptr(), slots.data_ptr(),
            final.data_ptr(), ptr(accept), ptr(labels), ptr(score), ptr(words),
            B, T, C, S, packed.A, packed.sched.numel(), packed.chunks, threads,
            ROUTES.index(route), rows, 0 if walk is None else 1 + WALKS.index(walk),
            _build.stream_handle(em),
        )
    _build.check(lib, err, f"viterbi_scan_fwd (route {route}, walk {walk})")
    _build.LAUNCHES["viterbi_scan_fwd"] += 1
    if accept is None:
        return slots, final
    _build.LAUNCHES["viterbi_backtrace"] += 1
    return slots, final, labels, score


def chain_probe(B, threads, frames, device):
    """Launch ``viterbi_chain_probe``: B blocks of ``threads`` threads run
    ``frames`` frames of the scan's chain without arcs (a dependent
    shared-memory load and a block barrier each).  Not a kernel of any
    path: it times one frame's floor for the scan's chain bound."""
    out = torch.empty((B * threads,), dtype=torch.int32, device=device)
    lib = _build.load_library("viterbi")
    with torch.cuda.device(device):
        err = lib.viterbi_chain_probe(out.data_ptr(), B, threads, frames,
                                      _build.stream_handle(out))
    _build.check(lib, err, "viterbi_chain_probe")
    return out


def walk_probe(B, frames, device):
    """Launch ``backtrace_chain_probe``: B blocks each walk ``frames`` (a
    multiple of 16) frames of the decode's walk on one thread (a dependent
    shared load of a word and its unpacking each).  Not a kernel of any
    path: it times one walk frame's floor, for the chain bounds of the
    decode's walk and of the dense backtrace."""
    out = torch.empty((B,), dtype=torch.int32, device=device)
    lib = _build.load_library("viterbi")
    with torch.cuda.device(device):
        err = lib.backtrace_chain_probe(out.data_ptr(), B, frames, _build.stream_handle(out))
    _build.check(lib, err, "backtrace_chain_probe")
    return out


def viterbi_scan(em, plan: Plan, input_lengths=None):
    """Decode ``em [B, T, C]`` against a bucketed plan.  Returns (labels
    [B, T] int32 with -1 beyond the length and on infeasible samples,
    score [B])."""
    B, T, C = em.shape
    if T == 0:
        raise ValueError("viterbi_scan needs at least one frame")
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    em = em.detach().to(torch.float32).contiguous()
    lengths = input_lengths.to(device=em.device, dtype=torch.int32).contiguous()
    src_b, lab_b, w_b, start, accept = plan.to(em.device)
    if _build.on_cuda(em):
        if int(plan.label_bucket.max()) >= C:
            raise ValueError(f"viterbi_scan: a label exceeds the {C} channels")
        _, _, labels, score = viterbi_scan_fwd_cuda(em, src_b, lab_b, w_b, start, lengths,
                                                    packed=plan.packed(em.device),
                                                    accept=accept)
        return labels, score
    slots, final = viterbi_scan_fwd_plain(em, src_b, lab_b, w_b, start, lengths)
    return viterbi_backtrace_plain(slots, final, accept, src_b, lab_b)
