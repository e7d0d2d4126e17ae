"""Arc tables: forward scores over them, and the batched Viterbi decode.

Counterpart of ``ArcTable``, ``_eps_closure``, ``forward_score``,
``forward_score_batch``, ``forward_score_batch_tables``, the accelerator
route ``_forward_batched_pallas`` and ``viterbi_batch`` of
``gtn_applications_tpu/ops/sparse.py``.

Forward scores: on CUDA tensors both batch functions take the kernel route
(``_forward_batched_kernels``: the epsilon closure of the start
potentials through ``seglse_pallas.seg_lse``, then the whole scan
``sparse_scan_pallas.scan_scores``; JAX takes it on the TPU); on CPU
tensors they take the plain version (``forward_score`` over the batch,
which autograd differentiates; JAX's ``vmap`` of it).  Both compute the
same numbers: each destination shifted by its own max, dead contributions
masked.

Decode: ``viterbi_batch`` buckets a shared, epsilon-free table's arcs
(``viterbi_scan_pallas.build_plan``) and runs the whole-scan Viterbi.
Tables that the plan refuses, tables with epsilon arcs or per-sample
fields wait for the per-step ``seg_max`` kernel (ROADMAP queue A item 7).

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
from .semiring import logaddexp, logsumexp, segment_logsumexp


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


def _forward_batched_kernels(em, table: ArcTable, input_lengths=None):
    """The kernel route over [B, S] state vectors: the closure of the
    start potentials through ``seg_lse`` (eps_depth launches), then one
    whole scan.  Fields may be shared or per sample, each on its own."""
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
        idx = arc_index(eps_src, eps_dst, S) if _build.on_cuda(em) else None
        zero = torch.zeros(eps_w.shape, dtype=torch.float32, device=em.device)
        acc = cur = alpha0
        for _ in range(depth):
            cur = seg_lse(cur, eps_src, eps_dst, eps_w, zero, idx)
            acc = logaddexp(acc, cur)
        alpha0 = acc
    return sparse_scan_pallas.scan_scores(em, fields, alpha0, accept,
                                          input_lengths, depth)


def forward_score_batch(em, table: ArcTable, input_lengths=None):
    """Batched forward score [B] with a shared table over ``em [B, T, C]``."""
    return forward_score_batch_tables(em, table, input_lengths)


def forward_score_batch_tables(em, tables: ArcTable, input_lengths=None):
    """Forward scores [B] with per-sample tables: each field [B, ·]
    (stacked per sample) or [·] (shared, e.g. the union skeleton's src/dst
    of ``wfst.compile.union_stack_arc_tables`` with per-sample labels and
    weights).  CUDA tensors take the kernels, CPU tensors the plain
    version."""
    if _build.on_cuda(em):
        return _forward_batched_kernels(em, tables, input_lengths)
    return _forward_batched_plain(em, tables, input_lengths)


def _not_ported(why):
    return NotImplementedError(
        f"viterbi_batch: {why}; only shared epsilon-free tables that the "
        "whole-scan plan takes are ported (the per-step seg_max path waits "
        "for ROADMAP queue A item 7)"
    )


def viterbi_batch(em, table: ArcTable, input_lengths=None):
    """Best path of each sample of ``em [B, T, C]`` through ``table``.

    Returns (labels [B, T] int32 on em's device, -1 at frames past the
    input length and for samples with no accepting path; score [B]).
    Ties go to the lowest arc id (the whole-scan kernel's rule)."""
    from . import viterbi_scan_pallas

    if table.eps_depth != 0 or table.eps_src.numel() > 0:
        raise _not_ported("the table has epsilon arcs")
    if table.src.dim() != 1:
        raise _not_ported("the table has per-sample fields")
    plan = viterbi_scan_pallas.build_plan(table)
    if plan is None:
        raise _not_ported("the table's in-degree bucket layout is refused")
    return viterbi_scan_pallas.viterbi_scan(em, plan, input_lengths)
