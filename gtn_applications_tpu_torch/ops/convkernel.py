"""Batched kernel-WFST scoring for the 1-D convolutional transducer.

Counterpart of ``gtn_applications_tpu/ops/convkernel.py``.  The reference
intersects every sliding window with every lexicon kernel graph one GTN
call at a time; here all kernel graphs are compiled once into banded
tables ``[V, S]`` (each kernel graph is a chain with self-loops and skips,
so the transition structure is a band of width 3) and every (batch,
window, vocab-entry) lattice is scored at once by a K-step recursion in
plain torch, with autograd.

The state emissions are the windows indexed by each state's label, where
JAX contracts the windows with a one-hot of the labels (a TPU gathers
serially): the values are the same exactly, which a matmul under TF32
would not give.  A large vocabulary is scored in V-chunks of 128 (padded
with dead entries), each under ``torch.utils.checkpoint``, at the same
threshold as JAX's ``jax.checkpoint`` over ``lax.map``.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .semiring import NEG, logsumexp_stack


class KernelTables(NamedTuple):
    """Banded per-vocab-entry lattice tables, all [V, S] (numpy arrays or
    tensors)."""

    label: np.ndarray        # emission channel per state
    w_self: np.ndarray       # NEG where the self-loop is absent
    w_prev: np.ndarray       # NEG where the s-1 -> s arc is absent
    w_skip: np.ndarray       # NEG where the s-2 -> s arc is absent
    accept: np.ndarray       # 0 / NEG
    widx_self: np.ndarray    # learnable param index per arc (-1 = none)
    widx_prev: np.ndarray
    widx_skip: np.ndarray
    num_params: int


_FIELDS = KernelTables._fields[:-1]


def compile_kernels(lexicon, blank_idx, blank_optional=True, spike=False):
    """Compile the lexicon's kernel graphs (``make_kernel_graph``) to tables.

    Kernel graph for entry x: state 0 loops on blank; for each position i,
    state 2i+1 consumes x[i] (with a self-loop unless ``spike``) and state
    2i+2 loops on blank; with ``blank_optional`` a skip 2i-1 -> 2i+1 exists
    when x[i-1] != x[i], and state 2n-1 also accepts.  Arc parameter
    indices follow the per-kernel arc creation order so that learnable
    kernel weights line up with ``kernel_params``.
    """
    V = len(lexicon)
    S = 2 * max((len(x) for x in lexicon), default=0) + 1
    label = np.zeros((V, S), np.int32)
    w_self = np.full((V, S), NEG, np.float32)
    w_prev = np.full((V, S), NEG, np.float32)
    w_skip = np.full((V, S), NEG, np.float32)
    accept = np.full((V, S), NEG, np.float32)
    widx_self = -np.ones((V, S), np.int32)
    widx_prev = -np.ones((V, S), np.int32)
    widx_skip = -np.ones((V, S), np.int32)

    pidx = 0
    for v, x in enumerate(lexicon):
        x = list(x)
        n = len(x)
        label[v, :] = blank_idx
        # arc order matches make_kernel_graph: (0,0,blank) first
        w_self[v, 0] = 0.0
        widx_self[v, 0] = pidx
        pidx += 1
        for i, c in enumerate(x):
            s_tok, s_blk = 2 * i + 1, 2 * i + 2
            label[v, s_tok] = c
            # (2i -> 2i+1, c)
            w_prev[v, s_tok] = 0.0
            widx_prev[v, s_tok] = pidx
            pidx += 1
            if not spike:
                w_self[v, s_tok] = 0.0
                widx_self[v, s_tok] = pidx
                pidx += 1
            # (2i+1 -> 2i+2, blank)
            w_prev[v, s_blk] = 0.0
            widx_prev[v, s_blk] = pidx
            pidx += 1
            w_self[v, s_blk] = 0.0
            widx_self[v, s_blk] = pidx
            pidx += 1
            if i > 0 and blank_optional and x[i - 1] != c:
                w_skip[v, s_tok] = 0.0
                widx_skip[v, s_tok] = pidx
                pidx += 1
        accept[v, 2 * n] = 0.0
        if blank_optional and n > 0:
            accept[v, 2 * n - 1] = 0.0

    return KernelTables(
        label=label, w_self=w_self, w_prev=w_prev, w_skip=w_skip,
        accept=accept, widx_self=widx_self, widx_prev=widx_prev,
        widx_skip=widx_skip, num_params=pidx,
    )


def tables_on(tables: KernelTables, device):
    """``tables`` with every field a tensor on ``device`` (labels and
    parameter indices int64)."""
    fields = {}
    for name in _FIELDS:
        x = torch.as_tensor(getattr(tables, name), device=device)
        fields[name] = x.long() if name == "label" or name.startswith("widx") else x
    return KernelTables(**fields, num_params=tables.num_params)


def _arc_weights(tables: KernelTables, kernel_params):
    """The structural masks plus the learnable per-arc weights."""
    if kernel_params is None:
        return tables.w_self, tables.w_prev, tables.w_skip
    p_ext = torch.cat([kernel_params, kernel_params.new_zeros(1)])
    n = tables.num_params

    def mix(base, widx):
        return base + p_ext[torch.where(widx >= 0, widx, n)]

    return (
        mix(tables.w_self, tables.widx_self),
        mix(tables.w_prev, tables.widx_prev),
        mix(tables.w_skip, tables.widx_skip),
    )


# flip to V-chunked (recomputed) scoring when the [B, W, K, V, S] emission
# tensor would exceed this many elements (~256 MB fp32)
_CHUNK_THRESHOLD = 64_000_000
_V_CHUNK = 128


def route(B, W, K, V, S):
    """"chunked" where the [B, W, K, V, S] emissions pass the threshold and
    the vocabulary is more than one chunk, else "direct"."""
    return "chunked" if B * W * K * V * S > _CHUNK_THRESHOLD and V > _V_CHUNK else "direct"


def _shift(x, k):
    """x moved k states up its last axis, NEG shifted in."""
    return torch.cat([torch.full_like(x[..., :k], NEG), x[..., :-k]], dim=-1)


def conv_transduce_scores(windows, tables: KernelTables, kernel_params=None,
                          viterbi=False):
    """Score every window against every kernel lattice.

    Args:
      windows: [B, W, K, C] log scores (K = kernel size).
      tables: compiled kernel tables [V, S] (numpy, or ``tables_on``).
      kernel_params: optional learnable flat arc weights [num_params].
      viterbi: max-semiring instead of log-semiring.

    Returns: [B, W, V] forward (or Viterbi) scores.  In the Viterbi mode
    ``amax`` splits the gradient evenly among tied maxima, as JAX's max
    does; in the log mode the final reduction's shift carries no gradient
    and the sum is floored at 1e-30, as in JAX.
    """
    B, W, K, C = windows.shape
    V, S = tables.label.shape
    tables = tables_on(tables, windows.device)
    if route(B, W, K, V, S) == "chunked":
        return _conv_scores_chunked(windows, tables, kernel_params, viterbi)
    w_self, w_prev, w_skip = _arc_weights(tables, kernel_params)

    # state emissions: [B, W, K, C] indexed by label [V, S] -> [B, W, K, V, S]
    em = windows[..., tables.label]

    alpha = torch.full((B, W, V, S), NEG, dtype=windows.dtype, device=windows.device)
    alpha[..., 0] = 0.0
    for k in range(K):
        arcs = [alpha + w_self, _shift(alpha, 1) + w_prev, _shift(alpha, 2) + w_skip]
        if viterbi:
            step = torch.amax(torch.stack(arcs, 0), dim=0)
        else:
            step = logsumexp_stack(arcs)
        alpha = em[:, :, k] + step

    final = alpha + tables.accept
    if viterbi:
        return torch.amax(final, dim=-1)
    m = torch.clamp(torch.amax(final, dim=-1), min=NEG).detach()
    return m + torch.log(
        torch.clamp(torch.sum(torch.exp(final - m[..., None]), dim=-1), min=1e-30)
    )


def _pad_dead(tables: KernelTables, pad_v):
    """``tables`` with ``pad_v`` dead entries appended (label 0, every arc
    and the accept NEG, no parameters)."""
    def dead(name, x):
        fill = -1 if name.startswith("widx") else 0 if name == "label" else NEG
        return torch.cat([x, torch.full((pad_v, x.shape[1]), fill, dtype=x.dtype,
                                        device=x.device)])

    return KernelTables(**{n: dead(n, getattr(tables, n)) for n in _FIELDS},
                        num_params=tables.num_params)


def _slice_tables(tables: KernelTables, start, size):
    return KernelTables(
        **{n: getattr(tables, n)[start:start + size] for n in _FIELDS},
        num_params=tables.num_params,
    )


def _conv_scores_chunked(windows, tables: KernelTables, kernel_params, viterbi):
    """The vocabulary in chunks of ``_V_CHUNK`` entries, each under
    ``torch.utils.checkpoint``: live memory and saved tensors are bounded
    by a chunk, at the cost of recomputing each chunk's forward once in the
    backward pass."""
    V = tables.label.shape[0]
    pad_v = (-V) % _V_CHUNK
    if pad_v:
        tables = _pad_dead(tables, pad_v)
    outs = []
    for start in range(0, V + pad_v, _V_CHUNK):
        chunk = _slice_tables(tables, start, _V_CHUNK)
        outs.append(checkpoint(
            lambda w, p, t=chunk: conv_transduce_scores(w, t, p, viterbi),
            windows, kernel_params, use_reentrant=False,
        ))
    return torch.cat(outs, dim=2)[:, :, :V]


def make_windows(inputs, kernel_size, stride, padded=False):
    """Pad by K//2 on both sides and extract strided windows.

    inputs: [B, T, C] -> [B, W, K, C] with W = (T - 1)//stride + 1.

    With ``padded=True`` the input already carries the K//2 frames on each
    side (the layer pads before normalization) and only the window
    extraction happens here.
    """
    B, T, C = inputs.shape
    if padded:
        x = inputs
        if T < kernel_size:
            raise ValueError("input shorter than one kernel window")
    else:
        if T == 0:
            raise ValueError("zero-length input")
        pad = kernel_size // 2
        x = torch.nn.functional.pad(inputs, (0, 0, pad, pad))
    # [B, W, C, K] -> [B, W, K, C]
    return x.unfold(1, kernel_size, stride).transpose(2, 3)
