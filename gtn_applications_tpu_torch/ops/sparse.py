"""Arc tables: forward scores over them, and the batched Viterbi decode.

Counterpart of ``ArcTable``, ``_eps_closure``, ``forward_score``,
``forward_score_batch``, ``forward_score_batch_tables``, the accelerator
route ``_forward_batched_pallas``, ``viterbi``, ``_viterbi_batched_pallas``
and ``viterbi_batch`` of ``gtn_applications_tpu/ops/sparse.py``.

Forward scores: on CUDA tensors both batch functions take the kernel route
(``_forward_batched_kernels``: the epsilon closure of the start
potentials through ``seglse_pallas.seg_lse``, then the whole scan
``sparse_scan_pallas.scan_scores``; JAX takes it on the TPU); on CPU
tensors they take the plain version (``forward_score`` over the batch,
which autograd differentiates; JAX's ``vmap`` of it).  Both compute the
same numbers: each destination shifted by its own max, dead contributions
masked.

Decode: ``viterbi_batch`` takes a shared, epsilon-free table.  It buckets
the table's arcs (``viterbi_scan_pallas.build_plan``) and runs the
whole-scan Viterbi; a table that the plan refuses (a hub state whose
in-degree blows the bucket grid up, as in a loaded backoff LM's
epsilon-removed table) goes to ``_viterbi_batched``, the tropical scan of
``seg_max`` steps and its backtrace (JAX takes the same two routes on the
TPU, the second as a ``jax.lax.scan`` of ``seg_max``): on CUDA tensors one
``segmax_pallas.seg_max_scan`` launch a batch.  ``viterbi`` is JAX's
per-sample oracle, with its 1e-6 near-tie rule.

Arc table convention (padded to fixed length; each field 1-D, or [B, ·]
per sample):
  src[A], dst[A], label[A]  : arc endpoints and emission channel (int32)
  weight[A]                 : arc weight (NEG for padding arcs)
  start[S], accept[S]       : state potentials (0 / NEG, or a final weight)
  eps_src[E], eps_dst[E], eps_weight[E], eps_depth : epsilon arcs
"""

import dataclasses

import torch

from . import _build
from .semiring import NEG, gather_channels, logaddexp, logsumexp, segment_logsumexp


@dataclasses.dataclass(frozen=True)
class ArcTable:
    """A compiled acceptor as CPU tensors (a plain dataclass: PyTorch needs
    no pytree).  Built by ``wfst.compile.to_arc_table``."""

    src: torch.Tensor
    dst: torch.Tensor
    label: torch.Tensor
    weight: torch.Tensor
    start: torch.Tensor
    accept: torch.Tensor
    eps_src: torch.Tensor
    eps_dst: torch.Tensor
    eps_weight: torch.Tensor
    eps_depth: int = 0

    def to(self, device):
        """The table with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "eps_depth"})


def _as2d(x):
    return x[None] if x.dim() == 1 else x


def _eps_closure(alpha, table: ArcTable):
    """Combine epsilon-path extensions of alpha [..., S], paths of length
    <= eps_depth (fields broadcast over the leading dims)."""
    S = alpha.shape[-1]
    acc = cur = alpha
    for _ in range(table.eps_depth):
        contrib = cur.gather(-1, table.eps_src.long().expand(
            cur.shape[:-1] + table.eps_src.shape[-1:])) + table.eps_weight
        cur = segment_logsumexp(contrib, table.eps_dst, S)
        acc = logaddexp(acc, cur)
    return acc


def _forward_batched_plain(em, table: ArcTable, input_lengths=None):
    """The plain forward scores [B] of em [B, T, C]: ``forward_score`` of
    each sample, written over the batch."""
    B, T, C = em.shape
    src, dst, label = (_as2d(f).long() for f in (table.src, table.dst, table.label))
    weight = _as2d(table.weight)
    S = table.start.shape[-1]
    A = src.shape[-1]
    lens = (torch.full((B,), T, device=em.device) if input_lengths is None
            else torch.as_tensor(input_lengths, device=em.device)).view(B, 1)
    alpha = _eps_closure(_as2d(table.start).expand(B, S), table)
    # gather_channels (a one-hot contraction) in JAX: exact selection, and
    # 0 for a label outside [0, C)
    lab = label.expand(B, A)
    ok = ((lab >= 0) & (lab < C))[:, None, :]
    em_arc = torch.where(ok, em.gather(2, torch.where(ok, lab[:, None, :], 0)
                                       .expand(B, T, A)), 0.0)
    src_b = src.expand(B, A)
    for t in range(T):
        contrib = alpha.gather(1, src_b) + weight + em_arc[:, t]
        new = _eps_closure(segment_logsumexp(contrib, dst, S), table)
        alpha = torch.where(t < lens, new, alpha)
    return logsumexp(alpha + _as2d(table.accept), dim=-1)


def forward_score(em, table: ArcTable, input_length=None):
    """Log-semiring forward score of emissions ``em [T, C]`` through
    ``table`` (1-D fields).  Each non-epsilon arc consumes one frame and
    scores ``weight + em[t, label]``; epsilon arcs consume none."""
    lens = None if input_length is None else torch.as_tensor(input_length).view(1)
    return _forward_batched_plain(em[None], table, lens)[0]


def _forward_batched_kernels(em, table: ArcTable, input_lengths=None, indexes=None):
    """The kernel route over [B, S] state vectors: the closure of the
    start potentials through ``seg_lse`` (eps_depth launches), then one
    whole scan.  Fields may be shared or per sample, each on its own.
    ``indexes``: see ``forward_score_batch``."""
    from . import sparse_scan_pallas
    from .seglse_pallas import arc_index, seg_lse

    B, T, C = em.shape
    fields = [_as2d(getattr(table, f)) for f in (
        "src", "dst", "label", "weight", "eps_src", "eps_dst", "eps_weight")]
    start, accept = _as2d(table.start), _as2d(table.accept)
    S = start.shape[-1]
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32, device=em.device)
    alpha0 = start.expand(B, S)
    eps_src, eps_dst, eps_w = fields[4:]
    depth = table.eps_depth if eps_src.shape[-1] else 0
    if depth:
        idx = None
        if _build.on_cuda(em):
            indexes = {} if indexes is None else indexes
            key = (em.device, S)
            if key not in indexes:
                indexes[key] = arc_index(eps_src, eps_dst, S)
            idx = indexes[key]
        acc = cur = alpha0
        for _ in range(depth):
            cur = seg_lse(cur, eps_src, eps_dst, eps_w, None, idx)
            acc = logaddexp(acc, cur)
        alpha0 = acc
    return sparse_scan_pallas.scan_scores(em, fields, alpha0, accept,
                                          input_lengths, depth)


def forward_score_batch(em, table: ArcTable, input_lengths=None, indexes=None):
    """Batched forward score [B] with a shared table over ``em [B, T, C]``.
    ``indexes``: a dict the caller keeps across scores of tables of one
    structure (re-weighted, as the Transducer's normaliser): the kernel
    route keeps the epsilon arcs' ``arc_index`` there by device and state
    count, so it is built once."""
    return forward_score_batch_tables(em, table, input_lengths, indexes)


def forward_score_batch_tables(em, tables: ArcTable, input_lengths=None, indexes=None):
    """Forward scores [B] with per-sample tables: each field [B, ·]
    (stacked per sample) or [·] (shared, e.g. the union skeleton's src/dst
    of ``wfst.compile.union_stack_arc_tables`` with per-sample labels and
    weights).  CUDA tensors take the kernels, CPU tensors the plain
    version.  ``indexes``: see ``forward_score_batch``."""
    if _build.on_cuda(em):
        return _forward_batched_kernels(em, tables, input_lengths, indexes)
    return _forward_batched_plain(em, tables, input_lengths)


def _require_epsilon_free(table: ArcTable):
    if table.eps_depth != 0 or table.eps_src.numel() > 0:
        raise ValueError("viterbi requires an epsilon-free arc table")


def viterbi(em, table: ArcTable, input_length=None):
    """Tropical scan with backpointers of ``em [T, C]`` over an
    epsilon-free table with 1-D fields: (labels [T] int32, score).

    JAX's per-sample oracle (``sparse.viterbi``): the winning arc of a
    state is the lowest arc id within 1e-6 of its best contribution, and
    a state without in-arcs keeps arc A (JAX: the empty segment's integer
    maximum; only unreachable states, which no best path visits, hold
    either).  ``labels[t]`` is -1 at frames past ``input_length`` and
    everywhere when no path accepts."""
    _require_epsilon_free(table)
    T = em.shape[0]
    S = table.start.shape[0]
    A = table.src.shape[0]
    src, dst, label = (getattr(table, f).long() for f in ("src", "dst", "label"))
    n = T if input_length is None else int(input_length)
    em_arc = gather_channels(em, table.label, batched=False)
    ids = torch.arange(A, device=em.device)
    alpha = table.start
    backarcs = []
    for t in range(T):
        if t >= n:
            backarcs.append(torch.full((S,), A, device=em.device))
            continue
        contrib = (alpha[src] + table.weight) + em_arc[t]
        best = torch.full((S,), NEG, dtype=contrib.dtype, device=em.device)
        best = best.scatter_reduce(0, dst, contrib, "amax")
        cand = torch.where(contrib >= best[dst] - 1e-6, ids, A)
        backarcs.append(torch.full((S,), A, device=em.device).scatter_reduce(
            0, dst, cand, "amin"))
        alpha = best
    final = alpha + table.accept
    score, state = final.max(), final.argmax()
    pad_src = torch.cat([src, src.new_zeros(1)])
    pad_label = torch.cat([label, label.new_full((1,), -1)])
    labels = [None] * T
    for t in reversed(range(T)):
        arc = backarcs[t][state]
        labels[t] = pad_label[arc]
        state = torch.where(arc < A, pad_src[arc], state)
    labels = torch.stack(labels).to(torch.int32) if T else torch.zeros(0, dtype=torch.int32)
    return torch.where(score > NEG / 2, labels, -1), score


def _viterbi_batched(em, table: ArcTable, input_lengths=None, plans=None):
    """The decode of ``em [B, T, C]`` through a shared, epsilon-free table
    by its tropical scan and backtrace (JAX's ``_viterbi_batched_pallas``):
    one ``seg_max_scan`` launch on CUDA tensors, nothing per frame; T
    ``seg_max`` steps and the walk in torch operations, its plain version,
    on CPU tensors.  ``plans``: see ``viterbi_batch``."""
    from . import segmax_pallas

    B, T, C = em.shape
    em = em.detach().to(torch.float32)
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32)
    plan = None
    if _build.on_cuda(em):
        plans = {} if plans is None else plans
        key = (em.device, C)
        if key not in plans:
            plans[key] = segmax_pallas.decode_plan(table, C, em.device)
        plan = plans[key]
    _, _, labels, score = segmax_pallas.seg_max_scan(
        em, table, torch.as_tensor(input_lengths), plan)
    return labels, score


def viterbi_batch(em, table: ArcTable, input_lengths=None, plans=None):
    """Best path of each sample of ``em [B, T, C]`` through ``table``, a
    shared (1-D fields) epsilon-free table with CPU tensors.

    Returns (labels [B, T] int32 on em's device, -1 at frames past the
    input length and for samples with no accepting path; score [B]).
    Routes as JAX on the TPU: a table whose in-degree bucket layout
    ``viterbi_scan_pallas.build_plan`` accepts takes the whole-scan
    Viterbi, any other the tropical scan of ``seg_max`` steps
    (``_viterbi_batched``).  Ties go to the lowest arc id on the exact
    maximum (every kernel's rule).  ``plans``: a dict the caller keeps
    across decodes of tables of one structure (a template re-weighted, as
    the Transducer's): the second route keeps its ``ScanPlan`` there by
    device and channel count, so the arc index and schedules are built
    once."""
    from . import viterbi_scan_pallas

    _require_epsilon_free(table)
    if any(getattr(table, f).dim() != 1 for f in (
            "src", "dst", "label", "weight", "start", "accept")):
        raise ValueError("viterbi_batch decodes a shared table (1-D fields); "
                         "the table has per-sample fields")
    if em.shape[1] == 0:
        raise ValueError("viterbi_batch needs at least one frame")
    plan = viterbi_scan_pallas.build_plan(table)
    if plan is not None:
        return viterbi_scan_pallas.viterbi_scan(em, plan, input_lengths)
    return _viterbi_batched(em, table, input_lengths, plans)
