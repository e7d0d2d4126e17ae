"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: the lattice kernels rely on exact ``expf``/``logf``
near their sum floors (1e-30 for CTC and the sparse scan, 1e-37 for the
dense scan).
Libraries land in ``build/`` at the root of the checkout (ignored by git),
named by a hash of their source and flags, so a changed source rebuilds
and an unchanged one is loaded as is.

Every wrapper that launches a kernel adds one to its entry of ``LAUNCHES``
there and nowhere else, so a run can show which kernels its path reached.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("gather", "ctc", "viterbi", "dense_scan", "sparse_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# The C entry points of each library: name -> number of pointer arguments
# followed by int arguments; every function ends with the stream and
# returns the cudaError_t of its launch.
_SIGNATURES = {
    "gather": {
        "gather_channels_fwd": (3, 4),
        "gather_channels_bwd": (3, 4),
        "gather_bwd_layout": (1, 2),
        "launch_probe": (0, 0),
    },
    "ctc": {
        "ctc_alpha": (6, 4),
        "ctc_grad": (9, 4),
        "ctc_chain_probe": (2, 1),
    },
    "viterbi": {
        "dense_backtrace": (3, 4),
        "viterbi_scan_fwd": (11, 11),
        "viterbi_chain_probe": (1, 3),
        "backtrace_chain_probe": (1, 2),
    },
    "dense_scan": {
        "dense_scan_fwd": (6, 4),
        "dense_scan_bwd": (9, 4),
        "factored_scan_fwd": (8, 5),
        "factored_scan_bwd": (12, 5),
        "factored_chain_probe": (1, 3),
    },
    "sparse_scan": {
        "seg_lse_fwd": (9, 7),
        "seg_lse_bwd": (11, 6),
        "sparse_scan_fwd": (11, 20),
        "sparse_scan_bwd": (18, 23),
        "sparse_scan_probe": (1, 3),
        "sparse_scan_fit": (1, 3),
        "seg_max": (9, 8),
        "seg_max_scan": (14, 14),
        "seg_max_scan_fit": (1, 3),
    },
}

LAUNCHES = {
    "gather_fwd": 0, "gather_bwd": 0, "ctc_alpha": 0, "ctc_grad": 0,
    "dense_bt": 0, "dense_scan_fwd": 0, "dense_scan_bwd": 0,
    "viterbi_scan_fwd": 0, "viterbi_backtrace": 0,
    "factored_scan_fwd": 0, "factored_scan_bwd": 0,
    "seg_lse_fwd": 0, "seg_lse_bwd": 0, "sparse_scan_fwd": 0, "sparse_scan_bwd": 0,
    "seg_max": 0, "seg_max_scan": 0,
}

# Shared memory one block can use on Hopper (227 KB).
MAX_SMEM = 232448

_libs = {}
_lock = threading.Lock()
build_seconds = None


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels of gtn_applications_tpu_torch cannot be built"
        )
    return path


def _target(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _compile_all():
    """Start one nvcc per missing library, wait for all, raise on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def _bind(name, path):
    lib = ctypes.CDLL(str(path))
    for fn_name, (n_ptr, n_int) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def load_library(name):
    """The ctypes handle of ``csrc/<name>.cu``, building every kernel
    library on the first call of the process."""
    global build_seconds
    with _lock:
        if not _libs:
            t0 = time.perf_counter()
            _compile_all()
            for lib_name in SOURCES:
                _libs[lib_name] = _bind(lib_name, _target(lib_name)[1])
            build_seconds = time.perf_counter() - t0
        return _libs[name]


def check(lib, err, what):
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def on_cuda(tensor):
    """Whether a kernel wrapper launches its kernel (CUDA tensor) or runs
    its plain version (CPU tensor); any other device raises."""
    if tensor.is_cuda:
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {tensor.device}")


def require_cuda(name, *tensors):
    """Raise unless every tensor is contiguous and on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def require(name, x, shape, dtype):
    """Raise unless ``x`` has this shape and dtype."""
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {x.dtype} "
            f"{tuple(x.shape)}"
        )


def stream_handle(tensor):
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
