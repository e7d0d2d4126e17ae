"""Where the gather backward (``gather_channels_bwd``, csrc/gather.cu) spends
its time.

    python -m gtn_applications_tpu_torch.scripts.profile_gather_bwd [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernel by parts itself, at the three shapes
``chip_smoke.py`` holds it (``chip_smoke.GATHER_CASES``: the CTC headline,
g [32, 250, 89] over 80 channels; S = 4,096 at B=8; ASG's force-aligned
shape, 44 targets):

- the kernel and an empty kernel (``gathers.launch_probe``, the launch
  floor), CUDA-event medians of 30 (``chip_smoke.gpu_median_ms``);
- copies of ``csrc/gather.cu`` with one part changed, built into
  ``build/profile_gather_bwd`` and timed the same way: a kernel that
  returns at once (``empty``), no plan (``no_plan``: no ranks and no order,
  so no sums either), no sums (``no_sums``), no g rows staged
  (``no_stage``), no dx tile stored (``no_store``), the sums of the last
  channel alone, the blank of a CTC lattice (``blank_only``), or of every
  channel but the last (``no_blank``), whose results are wrong; and four
  that change a choice of the design, whose results stay: the tile's
  copies issued once the labels have landed (``tile_after_labels``)
  instead of behind their copies, the sums a state at a time
  (``one_by_one``) instead of eight states' loads before their adds, one
  warp ranking every state (``one_rank_warp``) and 512 threads a block
  (``threads_512``);
- a copy that counts ``clock64`` cycles on thread 0 of every block: from
  the kernel's start to the labels in shared memory, to the plan placed
  and the tile landed, to the sums done and to the tile stored, averaged
  over the blocks.

One JSON line (also written to FILE) with the card's name and power
limit.  Run from the root of a checkout on a machine with one GPU.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "gtn_applications_tpu_torch" / "ops" / "csrc" / "gather.cu"
OUT_DIR = ROOT / "build" / "profile_gather_bwd"

ENTRY = "  const int b = blockIdx.x / tiles;\n"
RANKS = "    for (int k = k0; k < k1; ++k) {\n"
PLACE = "      if (c >= 0) order[first[c] + (Wr > 1 ? cnt_w[c] : 0) + rank[s]] = s;\n"
SUMS = "    int i = first[c];\n"
BATCHES = "    for (; i + 8 <= i1; i += 8) {\n"
CHANNEL = "  for (int c = warp; c < C; c += W) {\n    const int i1 = first[c + 1];\n"
LABELS_WAIT = "  __pipeline_wait_prior(1);  // this thread's labels\n"
STAGE_BLOCK = """  if constexpr (kStaged) {
    const long m = static_cast<long>(nf) * S;
    const long head = ((4 - ph) & 3) < m ? ((4 - ph) & 3) : m;
    const long body = (m - head) >> 2;
    float* dst = gs + ph;
    for (long i = tid; i < head; i += n) __pipeline_memcpy_async(dst + i, g_t + i, 4);
    for (long i = tid; i < body; i += n)
      __pipeline_memcpy_async(dst + head + 4 * i, g_t + head + 4 * i, 16);
    for (long i = head + 4 * body + tid; i < m; i += n)
      __pipeline_memcpy_async(dst + i, g_t + i, 4);
  }
  __pipeline_commit();
"""
STAGE = "  if constexpr (kStaged) {\n    const long m"
STORE = "      for (int c = lane; c < C; c += 32) dx_t[rr * C + c] = dxs[rr * cp + c];\n"
THREADS = "constexpr int kThreads = 256;"
LABELS_DONE = "    lab[s] = (c >= 0 && c < C) ? c : -1;  // outside [0, C): dropped\n  }\n  __syncthreads();\n"
PLAN_DONE = "  if constexpr (kStaged) __pipeline_wait_prior(0);\n  __syncthreads();\n"
SUMS_DONE = "  if constexpr (kStaged) {\n    __syncthreads();\n"
END = STORE + "  }\n}\n"
VARIANTS = {
    "empty": [(ENTRY, "  if (F >= 0) return;\n" + ENTRY)],
    "no_plan": [(RANKS, "    for (int k = k0; k < k0; ++k) {\n"), (PLACE, "")],
    "no_sums": [(SUMS, "    int i = i1;\n")],
    "tile_after_labels": [(STAGE_BLOCK, "  __pipeline_commit();\n"),
                          (LABELS_WAIT, LABELS_WAIT + STAGE_BLOCK)],
    "no_stage": [(STAGE, "  if constexpr (false) {\n    const long m")],
    "no_store": [(STORE, "      ;\n")],
    "blank_only": [(CHANNEL, CHANNEL + "    if (c != C - 1) continue;\n")],
    "no_blank": [(CHANNEL, CHANNEL + "    if (c == C - 1) continue;\n")],
    "one_by_one": [(BATCHES, "    for (; i1 < 0;) {\n")],
    "one_rank_warp": [("  return {true, static_cast<int>(f), static_cast<int>(w < 1 ? 1 : w),",
                       "  return {true, static_cast<int>(f), 1,")],
    "threads_512": [(THREADS, "constexpr int kThreads = 512;")],
}
RESULTS_STAY = ("tile_after_labels", "one_by_one", "one_rank_warp", "threads_512")
# thread 0's cycles into dx[b, t0, 0:4]: start to labels, to the plan and
# tile, to the sums, to the store (the staged route)
CLOCKS = [
    (ENTRY, "  const long long c0_ = clock64();\n" + ENTRY),
    (LABELS_DONE, LABELS_DONE + "  const long long c1_ = clock64();\n"),
    (PLAN_DONE, PLAN_DONE + "  const long long c2_ = clock64();\n"),
    (SUMS_DONE, SUMS_DONE + "    const long long c3_ = clock64();\n"),
    (END, STORE + "    __syncthreads();\n    if (tid == 0) {\n"
     "      dx_t[0] = static_cast<float>(c1_ - c0_);\n"
     "      dx_t[1] = static_cast<float>(c2_ - c1_);\n"
     "      dx_t[2] = static_cast<float>(c3_ - c2_);\n"
     "      dx_t[3] = static_cast<float>(clock64() - c3_);\n    }\n  }\n}\n"),
]


def patched(name, subs):
    """The kernels' source with ``subs`` applied, each of which must match
    exactly once."""
    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_gather_bwd: the {name} copy no longer matches the source")
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
    return _build._bind("gather", so)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.ops import _build, gathers

    if not torch.cuda.is_available():
        raise SystemExit("profile_gather_bwd needs a GPU")
    dev = torch.device("cuda")
    cases = {}
    for b, t, c, s, targets in cs.GATHER_CASES:
        _, idx, g = cs._gather_case(torch, dev, b, t, c, s, seed=s, targets=targets)
        cases[f"{'asg' if targets else 'ctc'}_S{s}"] = (g, idx, c)

    def times():
        return {name: cs.gpu_median_ms(torch, lambda a=a: gathers.gather_bwd_cuda(*a))
                for name, a in cases.items()}

    want = {name: gathers.gather_bwd_cuda(*a) for name, a in cases.items()}
    result = {"card": utils.card_name_and_power_limit(), "ms": times(),
              "launch_probe_ms": cs.gpu_median_ms(torch, lambda: gathers.launch_probe(dev)),
              "plans": {name: gathers.gather_bwd_plan(a[0].shape[2], a[2])
                        for name, a in cases.items()}}
    own = _build.load_library("gather")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["gather"] = build(name, subs)
            result[f"ms_{name}"] = times()
            if name in RESULTS_STAY:
                result[f"{name}_bitwise"] = {
                    case: bool(torch.equal(gathers.gather_bwd_cuda(*a), want[case]))
                    for case, a in cases.items()}
            print(name, result[f"ms_{name}"], flush=True)
        _build._libs["gather"] = build("clocks", CLOCKS)
        result["cycles"] = {}
        for name, a in cases.items():
            F = gathers.gather_bwd_plan(a[0].shape[2], a[2])[1]
            dx = gathers.gather_bwd_cuda(*a)[:, ::F, :4].reshape(-1, 4)
            cyc = dx.cpu().numpy().astype(np.float64).mean(axis=0)
            result["cycles"][name] = dict(zip(("labels", "plan_and_tile", "sums", "store"),
                                              cyc.tolist()))
        print(result["cycles"], flush=True)
    finally:
        _build._libs["gather"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_gather_bwd": result})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
