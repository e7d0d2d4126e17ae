"""Shared helpers for criteria: ragged target padding with shape bucketing."""

import numpy as np
import torch


def round_up(x, multiple):
    return ((max(int(x), 1) + multiple - 1) // multiple) * multiple


def pad_targets(targets, multiple=8, pad_value=0):
    """Pad a ragged list of int sequences to [B, L] plus lengths [B].

    L is rounded up to ``multiple`` to bound the number of distinct lattice
    shapes.  Already-padded 2-D arrays or tensors pass through with inferred
    full lengths.  Returns int32 CPU tensors.
    """
    if isinstance(targets, (np.ndarray, torch.Tensor)) and targets.ndim == 2:
        out = torch.as_tensor(np.asarray(targets), dtype=torch.int32)
        lengths = torch.full((out.shape[0],), out.shape[1], dtype=torch.int32)
        return out, lengths
    seqs = [np.asarray(t, dtype=np.int32).reshape(-1) for t in targets]
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = round_up(max((len(s) for s in seqs), default=1), multiple)
    out = np.full((len(seqs), L), pad_value, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return torch.from_numpy(out), torch.from_numpy(lengths)
