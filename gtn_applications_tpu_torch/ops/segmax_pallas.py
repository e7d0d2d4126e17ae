"""One tropical (max, +) step of the sparse-arc lattice, with backpointers.

Counterpart of ``seg_max`` in ``gtn_applications_tpu/ops/segmax_pallas.py``
(Pallas kernel ``_kernel``).  The module keeps the JAX file's name; the
kernel is CUDA C++ for Hopper (``csrc/sparse_scan.cu``, beside ``seg_lse``,
walking the same destination-sorted ``arc_index``):

    new[b, s]      = max(NEG, max over arcs a with dst[a] == s of
                              (alpha[b, src[a]] + w[a]) + e[a])
    best_arc[b, s] = the lowest arc id a attaining that maximum, if it is
                     strictly above NEG; else 2^30

The sum is formed in that order, so kernel and plain version agree bit for
bit.  An arc with an endpoint outside [0, S) is dropped (JAX pads with -1
endpoints and NEG weights).  A contribution equal to NEG never wins, and a
state reached only from NEG states stays NEG: float32 absorbs NEG + small.
Ties go to the lowest arc id on the exact maximum, the Pallas kernel's rule
(a strict ``>`` across its arc tiles); JAX's CPU oracle
``sparse.viterbi`` takes the lowest arc within 1e-6 instead.

``src``, ``dst``, ``w`` are ``[Ba, A]`` with Ba in {1, B} each on its own.
Emissions come in one of two modes: per arc, ``em [Ba, A]`` (JAX's
signature); or by label, ``em [B, C]`` (one frame's row) with
``label [Ba, A]``, where ``e[a] = em[b, label[a]]``, 0 for a label outside
[0, C) (``gather_channels``' rule).  The step decode uses the label mode:
it reads each frame's row where JAX builds a ``[T, B, A]`` arc-emission
tensor.  Forward only, as in JAX.  On CUDA tensors the wrapper launches the
kernel; on CPU tensors it runs the plain version.

The Viterbi decode of a shared, epsilon-free table scans that step over the
frames and walks the backpointers back (JAX's ``_viterbi_batched_pallas``:
a ``jax.lax.scan`` of ``seg_max``, then one of the backtrace).  Here that is
``seg_max_scan``: on CUDA tensors one launch of ``seg_max_scan_kernel``
(``csrc/sparse_scan.cu``) runs every frame of a sample on a thread-block
cluster, on the sparse scans' schedule (``sparse_scan_pallas.plan_schedule``
of the table's ``ScanPlan``, ``decode_plan``), and then the backtrace; on
CPU tensors T ``seg_max_plain`` steps (``seg_max_scan_plain``) and the walk
in torch operations (``seg_max_backtrace_plain``).  Both give the same
backarcs [B, T, S] (2^30 past a sample's length and where no live arc
reaches), final alpha, labels and scores, bit for bit.
"""

import ctypes

import torch

from . import _build
from . import sparse_scan_pallas as ssp
from .seglse_pallas import arc_index, take
from .semiring import NEG

BIG = 2**30  # best_arc of a state that no live arc reaches


def _arc_fields(alpha, src, dst, w, em, label):
    """(keys [B, A] with invalid arcs sent to segment S, contributions
    [B, A]) of one step."""
    B, S = alpha.shape
    A = max(x.shape[-1] for x in (src, dst, w))
    src = src.long().expand(B, A)
    dst = dst.long().expand(B, A)
    ok = (src >= 0) & (src < S) & (dst >= 0) & (dst < S)
    if label is None:
        e = em.expand(B, A)
    else:
        C = em.shape[-1]
        lab = label.long().expand(B, A)
        has = (lab >= 0) & (lab < C)
        e = torch.where(has, em.expand(B, C).gather(1, torch.where(has, lab, 0)), 0.0)
    a = alpha.gather(1, torch.where(ok, src, 0))
    return torch.where(ok, dst, S), (a + w) + e


def seg_max_plain(alpha, src, dst, w, em, label=None):
    """(new [B, S], best_arc [B, S] int32) by torch segment reductions."""
    B, S = alpha.shape
    keys, c = _arc_fields(alpha, src, dst, w, em, label)
    m = torch.full((B, S + 1), NEG, dtype=c.dtype, device=c.device)
    m = m.scatter_reduce(1, keys, c, "amax")
    ids = torch.arange(c.shape[1], device=c.device).expand_as(keys)
    win = (keys < S) & (c > NEG) & (c == m.gather(1, keys))
    arc = torch.full((B, S + 1), BIG, dtype=torch.int64, device=c.device)
    arc = arc.scatter_reduce(1, keys, torch.where(win, ids, BIG), "amin")
    return m[:, :S].contiguous(), arc[:, :S].to(torch.int32).contiguous()


def seg_max_cuda(alpha, w_s, em, idx):
    """Launch ``seg_max``: alpha [B, S] float32; w_s [1 or B, A] in the
    sorted order of ``idx`` (``take``).  With ``idx.label`` (an index built
    with labels), em is one frame's row [B, C] whose rows may be strided
    (``em[:, t]`` of [B, T, C]); without, em is [1 or B, A] in the sorted
    order.  -> (new [B, S], best_arc [B, S] int32)."""
    B, S = alpha.shape
    A = idx.order.shape[1]
    _build.require_cuda("seg_max", alpha, w_s, idx.order, idx.dptr, idx.src)
    _build.require("seg_max alpha", alpha, (B, S), torch.float32)
    if idx.order.shape[0] not in (1, B) or idx.dptr.shape[1] != S + 1:
        raise ValueError(f"seg_max: the arc index does not fit alpha {tuple(alpha.shape)}")
    if w_s.dtype != torch.float32 or w_s.dim() != 2 or w_s.shape[1] != A \
            or w_s.shape[0] not in (1, B):
        raise ValueError(f"seg_max: w must be float32 [1 or {B}, {A}]")
    if em.dtype != torch.float32 or em.dim() != 2 or em.device != alpha.device \
            or em.stride(1) != 1:
        raise ValueError("seg_max: em must be a float32 CUDA matrix of unit column stride")
    if idx.label is not None:
        _build.require_cuda("seg_max", alpha, idx.label)
        if em.shape[0] != B:
            raise ValueError(f"seg_max: the emission row must be [{B}, C]")
        C, em_rows, em_ld = em.shape[1], 1, em.stride(0)
    else:
        if em.shape[1] != A or em.shape[0] not in (1, B) or not em.is_contiguous():
            raise ValueError(f"seg_max: per-arc em must be contiguous [1 or {B}, {A}]")
        C, em_rows, em_ld = 0, int(em.shape[0] == B > 1), A
    new = torch.empty_like(alpha)
    arc = torch.empty((B, S), dtype=torch.int32, device=alpha.device)
    label = idx.label.data_ptr() if idx.label is not None else None
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(alpha.device):
        err = lib.seg_max(
            alpha.data_ptr(), idx.dptr.data_ptr(), idx.src.data_ptr(),
            idx.order.data_ptr(), w_s.data_ptr(), label, em.data_ptr(),
            new.data_ptr(), arc.data_ptr(), B, S, A, C, em_ld,
            int(idx.batched), int(w_s.shape[0] == B > 1), em_rows,
            _build.stream_handle(alpha),
        )
    _build.check(lib, err, "seg_max")
    _build.LAUNCHES["seg_max"] += 1
    return new, arc


def seg_max(alpha, src, dst, w, em, idx=None, label=None):
    """alpha [B, S]; src/dst/w [Ba, A], each with Ba in {1, B}
    independently; em [Ba, A] per arc, or [B, C] read by ``label``
    [Ba, A] -> (new [B, S], best_arc [B, S] int32).  ``idx`` is
    ``arc_index(src, dst, S[, label, C])`` where the caller already has it
    (CUDA only)."""
    as2d = lambda x: x[None] if x.dim() == 1 else x  # noqa: E731
    src, dst, w = as2d(src), as2d(dst), as2d(w).to(torch.float32)
    label = None if label is None else as2d(label)
    em = as2d(em).to(torch.float32)
    alpha = alpha.to(torch.float32).contiguous()
    if not _build.on_cuda(alpha):
        return seg_max_plain(alpha, src, dst, w, em, label)
    if idx is None:
        idx = (arc_index(src, dst, alpha.shape[1]) if label is None
               else arc_index(src, dst, alpha.shape[1], label, em.shape[1]))
    if label is None:
        em = take(em, idx.order)
    return seg_max_cuda(alpha, take(w, idx.order), em, idx)


# ---------------------------------------------------------------------------
# The whole tropical scan and its backtrace
# ---------------------------------------------------------------------------


def _as2d(x):
    return x[None] if x.dim() == 1 else x


def seg_max_scan_plain(em, table, lens):
    """(backarcs [B, T, S] int32, final alpha [B, S]) of em [B, T, C]
    through the shared, epsilon-free ``table``: T ``seg_max_plain`` steps
    (label mode: each frame's row read by the arcs' labels), alpha kept and
    the backarcs row 2^30 at frames t >= lens[b]."""
    B, T, C = em.shape
    src, dst, weight, label = (_as2d(getattr(table, f))
                               for f in ("src", "dst", "weight", "label"))
    S = table.start.shape[-1]
    live = (torch.arange(T, device=em.device)[:, None]
            < lens.to(em.device)[None, :])[:, :, None]
    alpha = table.start.expand(B, S).contiguous()
    backarcs = []
    for t in range(T):
        new, arc = seg_max_plain(alpha, src, dst, weight, em[:, t], label)
        alpha = torch.where(live[t], new, alpha)
        backarcs.append(torch.where(live[t], arc, BIG))
    return torch.stack(backarcs, dim=1), alpha


def seg_max_backtrace_plain(backarcs, final, table):
    """(labels [B, T] int32, score [B]) from the first argmax of final +
    accept, walking the backarcs (JAX's ``backstep``: label -1 and the
    state kept where the arc is past A); infeasible samples, score <=
    NEG / 2, decode to all -1."""
    B, T, _ = backarcs.shape
    src, label = table.src.long(), table.label.long()
    A = src.shape[0]
    pad_src = torch.cat([src, src.new_zeros(1)])
    pad_label = torch.cat([label, label.new_full((1,), -1)])
    scored = final + table.accept[None, :]
    score, state = scored.max(dim=1).values, scored.argmax(dim=1)
    labels = [None] * T
    for t in reversed(range(T)):
        arc = backarcs[:, t].gather(1, state[:, None])[:, 0].long().clamp(max=A)
        labels[t] = pad_label[arc]
        state = torch.where(arc < A, pad_src[arc], state)
    labels = torch.stack(labels, dim=1).to(torch.int32)
    return torch.where((score > NEG / 2)[:, None], labels, -1), score


def decode_plan(table, C, device):
    """The ``ScanPlan`` of a shared, epsilon-free decode table's structure
    (its arcs' endpoints and labels over C channels) on ``device``: its
    arc index, and its schedules as launches build them.  The structure of
    a re-weighted table does not change, so a caller keeps the plan."""
    src, dst, label = (_as2d(getattr(table, f)).to(device=device, dtype=torch.int32)
                       .contiguous() for f in ("src", "dst", "label"))
    empty = src[:, :0]
    return ssp.scan_plan(src, dst, label, empty, empty, table.start.shape[-1], C)


def decode_smem_words(sizes, S, C):
    """(state, tables) words (4 bytes) of a block's shared memory, as laid
    out by ``seg_max_scan_kernel``: ``state`` (alpha and the emission rows
    by frame parity, the own states' winning positions by frame parity,
    the hub chunks' maxima) always lies there; ``tables`` (the rank's
    sorted arcs: source and label packed, and weight; its list of rows by
    destination) there when both fit."""
    n, a, p = sizes["states"], sizes["arcs"], sizes["parts"]
    return 66 + 2 * S + 2 * C + 2 * n + 2 * p, 2 * a + sizes["dst_words"]


def decode_route(sizes, S, C):
    """Whether the tables lie in shared memory; raises where the state
    alone does not fit."""
    state, tables = decode_smem_words(sizes, S, C)
    limit = _build.MAX_SMEM // 4
    if state > limit:
        raise ValueError(f"seg_max_scan: the state of S={S} states does not fit in "
                         "shared memory")
    return state + tables <= limit


def decode_smem_bytes(sizes, S, C):
    """The dynamic shared memory a block of ``seg_max_scan`` launches with."""
    state, tables = decode_smem_words(sizes, S, C)
    return 4 * (state + tables * decode_route(sizes, S, C))


def _fit(k, smem, in_smem, device):
    """Clusters of k blocks of ``seg_max_scan`` (its tables in shared memory
    or not) with ``smem`` bytes of shared memory each that the card holds
    at once."""
    out = ctypes.c_int(0)
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(device):
        err = lib.seg_max_scan_fit(ctypes.addressof(out), k, smem, int(in_smem), None)
    _build.check(lib, err, "seg_max_scan_fit")
    return out.value


def max_active_clusters(plan, k, device):
    """How many clusters of k blocks of ``seg_max_scan`` on this plan's
    table the card holds at once (the launch raises at 0)."""
    sizes = ssp.plan_schedule(plan, k).sizes
    return _fit(k, decode_smem_bytes(sizes, plan.S, plan.C),
                decode_route(sizes, plan.S, plan.C), device)


def choose_cluster(plan, B, device):
    """The cluster size ``seg_max_scan`` launches with for a batch of B: the
    largest k with B k blocks on the card's multiprocessors whose B
    clusters the card holds at once (else the largest with B k blocks on
    the card: its clusters then run in waves).  Kept on the plan.  Unlike
    the sparse scans' ``choose_cluster``, it asks nothing of a backward,
    which the decode never launches."""
    key = ("decode cluster", B)
    if key not in plan.schedules:
        sizes = ssp.cluster_candidates(
            B, torch.cuda.get_device_properties(device).multi_processor_count)
        choice = sizes[0]
        for k in sizes:
            if _fit(k, 0, False, device) >= B and max_active_clusters(plan, k, device) >= B:
                choice = k
                break
        plan.schedules[key] = choice
    return plan.schedules[key]


def decode_arcs(plan):
    """The kernel's arcs of a decode plan, in the index's sorted order:
    source | label << 16 int32 (source 0 where it lies outside [0, S), and
    label C where it lies outside [0, C)), the arc id at each position
    (int32), and where the source is outside [0, S) (the kernel's weight
    there is -inf, so the arc never wins).  Built once, kept on the plan."""
    key = "decode arcs"
    if key not in plan.schedules:
        idx = plan.main
        dropped = idx.src < 0
        label = torch.where(idx.label < 0, plan.C, idx.label)
        packed = torch.where(dropped, 0, idx.src) | (label << 16)
        plan.schedules[key] = (packed.to(torch.int32).contiguous(),
                               idx.order.to(torch.int32).contiguous(), dropped)
    return plan.schedules[key]


def seg_max_scan_cuda(em, w_s, start, accept, lens, plan, cluster=None):
    """Launch ``seg_max_scan``: em [B, T, C] float32 (rows may be strided,
    channels contiguous), w_s [1, A] in the sorted order of ``plan.main``
    (``take``), start and accept [S] float32, lens [B] int32, ``plan`` from
    ``decode_plan`` -> (backarcs [B, T, S] int32, final alpha [B, S],
    labels [B, T] int32, score [B]).  ``cluster``: blocks a sample (1, 2,
    4 or 8; default ``choose_cluster``); a size whose cluster does not fit
    on the card raises at launch."""
    idx = plan.main
    if idx is None:
        raise ValueError("seg_max_scan: the plan has no CUDA index (built on the CPU?)")
    if idx.batched or plan.eps is not None or idx.label is None:
        raise ValueError("seg_max_scan: the plan must be a shared, epsilon-free table's "
                         "with labels (decode_plan)")
    B, T, C = em.shape
    S, A = plan.S, idx.order.shape[1]
    _build.require_cuda("seg_max_scan", w_s, start, accept, lens, idx.dptr, plan.src,
                        plan.label)
    if (em.dtype != torch.float32 or not em.is_cuda or em.device != w_s.device
            or em.stride(2) != 1):
        raise ValueError("seg_max_scan: em must be a float32 CUDA tensor of unit "
                         "channel stride")
    if C != plan.C or T < 1:
        raise ValueError(f"seg_max_scan: em {tuple(em.shape)} does not fit the plan")
    _build.require("seg_max_scan w", w_s, (1, A), torch.float32)
    _build.require("seg_max_scan start", start, (S,), torch.float32)
    _build.require("seg_max_scan accept", accept, (S,), torch.float32)
    _build.require("seg_max_scan lengths", lens, (B,), torch.int32)
    k = choose_cluster(plan, B, em.device) if cluster is None else cluster
    sched = ssp.plan_schedule(plan, k)
    z = sched.sizes
    in_smem = decode_route(z, S, C)
    dev = em.device
    backarcs = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    final = torch.empty((B, S), dtype=torch.float32, device=dev)
    labels = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    arcs, ids, dropped = decode_arcs(plan)
    w_s = w_s.masked_fill(dropped, -float("inf"))
    lib = _build.load_library("sparse_scan")
    with torch.cuda.device(dev):
        err = lib.seg_max_scan(
            em.data_ptr(), lens.data_ptr(), start.data_ptr(), accept.data_ptr(),
            arcs.data_ptr(), w_s.data_ptr(), ids.data_ptr(), plan.src.data_ptr(),
            plan.label.data_ptr(), sched.device[0].data_ptr(), backarcs.data_ptr(),
            final.data_ptr(), labels.data_ptr(), score.data_ptr(),
            B, T, C, S, A, em.stride(0), em.stride(1), sched.k, z["stride"],
            z["dst_words"], z["states"], z["arcs"], z["parts"], int(in_smem),
            _build.stream_handle(em),
        )
    _build.check(lib, err, f"seg_max_scan (cluster of {sched.k})")
    _build.LAUNCHES["seg_max_scan"] += 1
    return backarcs, final, labels, score


def seg_max_scan(em, table, lens, plan=None):
    """The Viterbi decode of em [B, T, C] through the shared, epsilon-free
    ``table`` with lengths ``lens`` [B]: (backarcs [B, T, S] int32, final
    alpha [B, S], labels [B, T] int32, score [B]).  On CUDA tensors one
    ``seg_max_scan`` launch (``plan``: ``decode_plan(table, C, em.device)``,
    built here when not given); on CPU tensors the plain scan and
    backtrace."""
    em = em.to(torch.float32)
    if not _build.on_cuda(em):
        table = table.to(em.device)
        backarcs, final = seg_max_scan_plain(em, table, lens)
        return (backarcs, final) + seg_max_backtrace_plain(backarcs, final, table)
    dev = em.device
    if em.stride(2) != 1:
        em = em.contiguous()
    if plan is None:
        plan = decode_plan(table, em.shape[2], dev)
    w_s = take(_as2d(table.weight).to(dev), plan.main.order)
    start, accept = (getattr(table, f).to(device=dev, dtype=torch.float32).contiguous()
                     for f in ("start", "accept"))
    return seg_max_scan_cuda(em, w_s, start, accept,
                             lens.to(device=dev, dtype=torch.int32).contiguous(), plan)
