"""Dense Viterbi backtrace, as a kernel.

Counterpart of ``dense_backtrace`` in
``gtn_applications_tpu/ops/viterbi_scan_pallas.py`` (Pallas kernel
``_dense_bt_kernel``).  The module keeps the JAX file's name; the kernel is
CUDA C++ for Hopper (``csrc/viterbi.cu``).  The sparse whole-scan Viterbi
of that file (``viterbi_scan`` and its two kernels) waits for ROADMAP
queue A item 7.

Layout: backpointers are ``[B, T-1, C]`` (sample-major, so one sample's
table is one contiguous slice), where JAX takes ``[T-1, B, C]``.
"""

import torch

from . import _build


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
