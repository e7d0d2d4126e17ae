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
"""

import collections
from dataclasses import dataclass, field
from typing import Dict

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
                          lengths):
    """Launch ``viterbi_scan_fwd``: em [B, T, C] float32, the plan's
    [D, S] buckets and start [S], lengths [B] int32 -> (slots [B, T, S]
    int32, final alpha [B, S]).  Every label must lie in [0, C)."""
    _build.require_cuda("viterbi_scan_fwd", em, src_bucket, label_bucket,
                        w_bucket, start, lengths)
    B, T, C = em.shape
    _build.require("viterbi_scan_fwd em", em, (B, T, C), torch.float32)
    D, S = _plan_check("viterbi_scan_fwd", src_bucket, label_bucket, w_bucket,
                       start)
    _build.require("viterbi_scan_fwd lengths", lengths, (B,), torch.int32)
    slots = torch.empty((B, T, S), dtype=torch.int32, device=em.device)
    final = torch.empty((B, S), dtype=torch.float32, device=em.device)
    lib = _build.load_library("viterbi")
    with torch.cuda.device(em.device):
        err = lib.viterbi_scan_fwd(
            em.data_ptr(), src_bucket.data_ptr(), label_bucket.data_ptr(),
            w_bucket.data_ptr(), start.data_ptr(), lengths.data_ptr(),
            slots.data_ptr(), final.data_ptr(), B, T, C, S, D,
            _build.MAX_SMEM, _build.stream_handle(em),
        )
    _build.check(lib, err, "viterbi_scan_fwd")
    _build.LAUNCHES["viterbi_scan_fwd"] += 1
    return slots, final


def viterbi_backtrace_cuda(slots, final_alpha, accept, src_bucket,
                           label_bucket):
    """Launch ``viterbi_backtrace``: slots [B, T, S] int32, final alpha
    [B, S] and accept [S] float32, the plan's [D, S] buckets -> (labels
    [B, T] int32, score [B])."""
    _build.require_cuda("viterbi_backtrace", slots, final_alpha, accept,
                        src_bucket, label_bucket)
    B, T, S = slots.shape
    D, _ = _plan_check("viterbi_backtrace", src_bucket, label_bucket)
    _build.require("viterbi_backtrace slots", slots, (B, T, S), torch.int32)
    _build.require("viterbi_backtrace final", final_alpha, (B, S), torch.float32)
    _build.require("viterbi_backtrace accept", accept, (S,), torch.float32)
    labels = torch.empty((B, T), dtype=torch.int32, device=slots.device)
    score = torch.empty((B,), dtype=torch.float32, device=slots.device)
    lib = _build.load_library("viterbi")
    with torch.cuda.device(slots.device):
        err = lib.viterbi_backtrace(
            slots.data_ptr(), final_alpha.data_ptr(), accept.data_ptr(),
            src_bucket.data_ptr(), label_bucket.data_ptr(), labels.data_ptr(),
            score.data_ptr(), B, T, S, D, _build.MAX_SMEM,
            _build.stream_handle(slots),
        )
    _build.check(lib, err, "viterbi_backtrace")
    _build.LAUNCHES["viterbi_backtrace"] += 1
    return labels, score


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
        slots, final = viterbi_scan_fwd_cuda(em, src_b, lab_b, w_b, start, lengths)
        return viterbi_backtrace_cuda(slots, final, accept, src_b, lab_b)
    slots, final = viterbi_scan_fwd_plain(em, src_b, lab_b, w_b, start, lengths)
    return viterbi_backtrace_plain(slots, final, accept, src_b, lab_b)
