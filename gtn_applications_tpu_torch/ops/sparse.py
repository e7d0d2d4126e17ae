"""Arc tables and the batched Viterbi decode over them (partial port).

Counterpart of ``ArcTable`` and ``viterbi_batch`` of
``gtn_applications_tpu/ops/sparse.py``.  Only the decode of a shared,
epsilon-free table is here: ``viterbi_batch`` buckets the table's arcs
(``viterbi_scan_pallas.build_plan``) and runs the whole-scan Viterbi
(``viterbi_scan_pallas.viterbi_scan``: its CUDA kernels on CUDA tensors,
its plain versions on CPU tensors).  Tables that the plan refuses, tables
with epsilon arcs or per-sample fields, and the forward scores of the
sparse tier (``forward_score*``, the per-step ``seg_lse`` / ``seg_max``
kernels and the sparse whole scan) wait for ROADMAP queue A item 7.

Arc table convention (padded to fixed length):
  src[A], dst[A], label[A]  : arc endpoints and emission channel (int32)
  weight[A]                 : arc weight (NEG for padding arcs)
  start[S], accept[S]       : state potentials (0 / NEG, or a final weight)
  eps_src[E], eps_dst[E], eps_weight[E], eps_depth : epsilon arcs
"""

import dataclasses

import torch


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


def _not_ported(why):
    return NotImplementedError(
        f"viterbi_batch: {why}; only shared epsilon-free tables that the "
        "whole-scan plan takes are ported (the per-step seg_max path and the "
        "sparse tier wait for ROADMAP queue A item 7)"
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
