"""Where the dense backtrace (``dense_backtrace``, csrc/viterbi.cu) spends its
time.

    python -m gtn_applications_tpu_torch.scripts.profile_dense_bt [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernel by parts itself, at the three shapes
``chip_smoke.py`` times it (the ASG headline, B=32, T=250, C=80, and
``chip_smoke.DENSE_BT_MORE``: B=8, T=1000, C=80 and B=8, T=250, C=81):

- the kernel (CUDA-event medians of 30, ``chip_smoke.gpu_median_ms``) and
  the walk's chain bound (T - 1 frames of ``backtrace_chain_probe``);
- copies of ``csrc/viterbi.cu`` with one part changed, built into
  ``build/profile_dense_bt`` and timed the same way: a kernel that returns
  at once (``empty``: the launch), the ring's copies and handshakes with
  no frame walked (``no_walk``), the walk without its path stores
  (``no_path_store``), whose results are wrong; and eight that change a
  choice of the design, whose results stay: the path written to shared
  memory a frame at a time and stored coalesced by warp 0 a chunk at a
  time (``path_shared``), chunks of about 1,024, 8,192 and 16,384 words
  (``chunk_1k``, ``chunk_8k``, ``chunk_16k``), the walker's arrive on a
  free slot relaxed instead of a release (``relaxed_arrive``: no wait for
  its path stores), 256 and 64 threads a block (``threads_256``,
  ``threads_64``: seven copying warps and one) and the copiers waiting
  for a free slot by ``mbarrier.test_wait`` and ``__nanosleep`` instead
  of ``try_wait`` (``copier_backoff``);
- a copy that counts ``clock64`` cycles on the walking thread: from the
  kernel's start to the first chunk landed, and the walk's cycles a frame
  after it, averaged over the samples.

One JSON line (also written to FILE) with the card's name and power
limit.  Run from the root of a checkout on a machine with one GPU.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "gtn_applications_tpu_torch" / "ops" / "csrc" / "viterbi.cu"
OUT_DIR = ROOT / "build" / "profile_dense_bt"

ENTRY = "  const int b = blockIdx.x;\n  const long g_b = static_cast<long>(b) * (T - 1) * C;"
WALK = ("      for (int t = t1 - 1; t >= t0; --t, row -= C) {\n        state = row[state];\n"
        "        path_b[t] = state;\n      }\n")
WALKER_END = "    }\n    return;\n  }\n  const int ct = threadIdx.x - 32;"
# path_shared: all of warp 0 stays, lane 0 walks into a shared buffer of the
# chunk's frames (two, by chunk parity) and the warp stores it coalesced
WALKER = ("    if (threadIdx.x > 0) return;\n    int state = last[b];\n    path_b[T - 1] = state;\n"
          "    for (int c = 0; c < nck; ++c) {\n"
          "      const int j = nck - 1 - c, t0 = j * F, t1 = min(t0 + F, T - 1), r = c % kBtRing;\n"
          "      mbar_wait(&full[r], (c / kBtRing) & 1);\n")
WALKER_SHARED = ("    const int lane = threadIdx.x;\n    int state = last[b];\n"
                 "    if (lane == 0) path_b[T - 1] = state;\n"
                 "    for (int c = 0; c < nck; ++c) {\n"
                 "      const int j = nck - 1 - c, t0 = j * F, t1 = min(t0 + F, T - 1), "
                 "r = c % kBtRing;\n"
                 "      int* out = bt_ring + kBtRing * slot + (c & 1) * F - t0;\n"
                 "      if (lane == 0) {\n      mbar_wait(&full[r], (c / kBtRing) & 1);\n")
ARRIVE_END = ("                   ::\"r\"(smem_addr(&empty[r])) : \"memory\");\n    }\n"
              "    return;\n")
ARRIVE_END_SHARED = ("                   ::\"r\"(smem_addr(&empty[r])) : \"memory\");\n      }\n"
                     "      __syncwarp();\n"
                     "      for (int t = t0 + lane; t < t1; t += 32) path_b[t] = out[t];\n"
                     "    }\n    return;\n")
SMEM = ("  const size_t smem = F ? static_cast<size_t>(kBtRing) * bt_slot_words(F, C) * "
        "sizeof(int) : 0;")
COPIER_WAIT = ("    if (c >= kBtRing) mbar_wait(&empty[r], (c / kBtRing - 1) & 1);"
               "  // chunk c - kBtRing walked\n")
MBAR_WAIT = "__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {"
MBAR_TEST = ("__device__ __forceinline__ bool mbar_test(unsigned long long* bar, unsigned parity) {\n"
             "  unsigned done;\n  asm volatile(\"{\\n .reg .pred q;\\n mbarrier.test_wait.parity"
             ".shared::cta.b64 q, [%1], %2;\\n selp.u32 %0, 1, 0, q;\\n}\"\n"
             "               : \"=r\"(done) : \"r\"(smem_addr(bar)), \"r\"(parity) : \"memory\");\n"
             "  return done;\n}\n\n")
VARIANTS = {
    "empty": [(ENTRY, "  if (F >= 0) return;\n" + ENTRY)],
    "no_walk": [(WALK, "")],
    "no_path_store": [(WALK, WALK.replace("        path_b[t] = state;\n", "")),
                      (WALKER_END, WALKER_END.replace("    return;\n",
                                                      "    path_b[0] = state;\n    return;\n"))],
    "path_shared": [(WALKER, WALKER_SHARED),
                    (WALK, WALK.replace("path_b[t] = state;", "out[t] = state;")),
                    (ARRIVE_END, ARRIVE_END_SHARED),
                    (SMEM, SMEM.replace("static_cast<size_t>(kBtRing) * bt_slot_words(F, C) *",
                                        "(static_cast<size_t>(kBtRing) * bt_slot_words(F, C) + "
                                        "2 * F) *"))],
    "chunk_1k": [("constexpr int kBtChunkWords = 4096;", "constexpr int kBtChunkWords = 1024;")],
    "chunk_8k": [("constexpr int kBtChunkWords = 4096;", "constexpr int kBtChunkWords = 8192;")],
    "chunk_16k": [("constexpr int kBtChunkWords = 4096;", "constexpr int kBtChunkWords = 16384;")],
    "relaxed_arrive": [("      asm volatile(\"{\\n .reg .b64 st;\\n mbarrier.arrive.shared::cta.b64 st, "
                        "[%0];\\n}\"\n",
                        "      asm volatile(\"{\\n .reg .b64 st;\\n mbarrier.arrive.relaxed.cta"
                        ".shared::cta.b64 st, [%0];\\n}\"\n")],
    "threads_256": [("constexpr int kBtThreads = 128;", "constexpr int kBtThreads = 256;")],
    "threads_64": [("constexpr int kBtThreads = 128;", "constexpr int kBtThreads = 64;")],
    "copier_backoff": [(COPIER_WAIT, COPIER_WAIT.replace(
        "mbar_wait(&empty[r], (c / kBtRing - 1) & 1);",
        "{\n      while (!mbar_test(&empty[r], (c / kBtRing - 1) & 1)) __nanosleep(64);\n    }")),
        (MBAR_WAIT, MBAR_TEST + MBAR_WAIT)],
}
RESULTS_STAY = ("path_shared", "chunk_1k", "chunk_8k", "chunk_16k", "relaxed_arrive",
                "threads_256", "threads_64", "copier_backoff")
# the walking thread's cycles into path[b, 0] (kernel start to the first
# chunk landed) and path[b, 1] (the walk after it)
CLOCKS = [
    (ENTRY, "  const long long c_start = clock64();\n" + ENTRY),
    ("      mbar_wait(&full[r], (c / kBtRing) & 1);\n",
     "      mbar_wait(&full[r], (c / kBtRing) & 1);\n"
     "      if (c == 0) c_first = clock64();\n"),
    ("    path_b[T - 1] = state;\n    for (int c = 0; c < nck; ++c) {",
     "    path_b[T - 1] = state;\n    long long c_first = 0;\n"
     "    for (int c = 0; c < nck; ++c) {"),
    (WALKER_END, WALKER_END.replace(
        "    return;\n", "    path_b[0] = static_cast<int>(c_first - c_start);\n"
        "    path_b[1] = static_cast<int>(clock64() - c_first);\n    return;\n")),
]


def patched(name, subs):
    """The kernels' source with ``subs`` applied, each of which must match
    exactly once."""
    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_dense_bt: the {name} copy no longer matches the source")
        src = src.replace(old, new)
    return src


def build(name, subs):
    """A copy of the kernels' source with ``subs`` applied, compiled as the
    port compiles its own; returns the bound library."""
    from gtn_applications_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(patched(name, subs))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return _build._bind("viterbi", so)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.scripts.compare_ctc_viterbi import walk_frame_us

    if not torch.cuda.is_available():
        raise SystemExit("profile_dense_bt needs a GPU")
    dev = torch.device("cuda")
    cases = {"x".join(map(str, shape)): cs.asg_headline_inputs(torch, dev, *shape)
             for shape in ((cs.B, cs.T, cs.ASG_C),) + cs.DENSE_BT_MORE}

    def times():
        return {name: cs.gpu_median_ms(torch, lambda c=c: vsp.dense_backtrace_cuda(*c))
                for name, c in cases.items()}

    want = {name: vsp.dense_backtrace_cuda(*c) for name, c in cases.items()}
    walk_us = walk_frame_us(torch, cs, dev)
    result = {"card": utils.card_name_and_power_limit(), "ms": times(),
              "plans": {name: vsp.dense_bt_plan(c[0].shape[1] + 1, c[0].shape[2])
                        for name, c in cases.items()},
              "walk_frame_us": walk_us,
              "chain_bound_ms": {name: c[0].shape[1] * walk_us * 1e-3
                                 for name, c in cases.items()}}
    own = _build.load_library("viterbi")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["viterbi"] = build(name, subs)
            result[f"ms_{name}"] = times()
            if name in RESULTS_STAY:
                result[f"{name}_bitwise"] = {
                    case: bool(torch.equal(vsp.dense_backtrace_cuda(*c), want[case]))
                    for case, c in cases.items()}
            print(name, result[f"ms_{name}"], flush=True)
        _build._libs["viterbi"] = build("clocks", CLOCKS)
        result["cycles_to_first_chunk"], result["cycles_per_frame"] = {}, {}
        for name, c in cases.items():
            out = vsp.dense_backtrace_cuda(*c)[:, :2].cpu().numpy().astype(np.float64)
            result["cycles_to_first_chunk"][name] = float(out[:, 0].mean())
            result["cycles_per_frame"][name] = float(out[:, 1].mean() / c[0].shape[1])
        print(result["cycles_to_first_chunk"], result["cycles_per_frame"], flush=True)
    finally:
        _build._libs["viterbi"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_dense_bt": result})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
