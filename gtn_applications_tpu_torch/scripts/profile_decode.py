"""Where a frame of ``seg_max_scan`` goes, on the 4-gram decode table.

    python -m gtn_applications_tpu_torch.scripts.profile_decode [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the decode kernel by parts itself, on the inputs of
``chip_smoke.segmax_scan_inputs`` (the unpruned grapheme 4-gram's decode
table, S=1,058, A=35,455, C=12; B=32, T=300, ragged lengths, one
infeasible sample) and on its first sample alone:

- the kernel at each cluster size (CUDA-event medians of 30,
  ``chip_smoke.gpu_median_ms``), with how many of its clusters the card
  holds at once and whether its tables lie in shared memory;
- copies of ``csrc/sparse_scan.cu`` with one part of the frame replaced,
  built into ``build/profile_decode`` and timed the same way: the pushes
  written to the rank's own copy only (``local_push``), the cluster
  barrier replaced by a block barrier (``block_sync``), both, and the
  arc table loads replaced by a constant (``no_table_loads``).  Their
  results are wrong; only their times mean something;
- a copy that counts ``clock64`` cycles in each warp: per frame, the pass
  over the rank's slots (its slowest warp, and the mean), the row write
  and emission wait after it, and the cluster barrier; reported per rank,
  averaged over the samples, and the SM clock the cycles are at.

One JSON line (also written to FILE) with the card's name and power
limit.  Run from the root of a checkout on a machine with one GPU.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "gtn_applications_tpu_torch" / "ops" / "csrc" / "sparse_scan.cu"
OUT_DIR = ROOT / "build" / "profile_decode"

PUSH = "                push(cl, next, s, live ? v : kNeg);"
LOCAL_PUSH = "                next[s] = live ? v : kNeg;"
SYNC = "    __pipeline_wait_prior(0);\n    cl.sync();\n  }\n  if (t_live > 0) write_row(t_live - 1);"
LOADS = "        pk[j] = arcs[kc];\n        wv[j] = w[kc];"
VARIANTS = {
    "local_push": [(PUSH, LOCAL_PUSH)],
    "block_sync": [(SYNC, SYNC.replace("cl.sync();", "__syncthreads();"))],
    "local_push_block_sync": [(PUSH, LOCAL_PUSH),
                              (SYNC, SYNC.replace("cl.sync();", "__syncthreads();"))],
    "no_table_loads": [(LOADS, "        pk[j] = kc & 1023;\n        wv[j] = 0.0f;")],
}
# per warp and frame: the slot pass, what follows it up to the barrier, and
# the barrier; written into final_alpha after the last barrier, where no
# rank writes any more
CLOCKS = [
    ("  for (int t = 0; t < t_live; ++t) {\n    const float* prev = (t & 1) ? al0 : al1;",
     "  long long c_pass = 0, c_tail = 0, c_sync = 0;\n"
     "  for (int t = 0; t < t_live; ++t) {\n    const long long c0 = clock64();\n"
     "    const float* prev = (t & 1) ? al0 : al1;"),
    ("    if (t > 0) write_row(t - 1);\n    __pipeline_wait_prior(0);\n    cl.sync();\n  }",
     "    const long long c1 = clock64();\n    if (t > 0) write_row(t - 1);\n"
     "    __pipeline_wait_prior(0);\n    const long long c2 = clock64();\n    cl.sync();\n"
     "    c_pass += c1 - c0;\n    c_tail += c2 - c1;\n    c_sync += clock64() - c2;\n  }"),
    ("  if (rank != 0) return;\n\n  // the backtrace",
     "  if (lane == 0) {\n"
     "    float* out = final_alpha + static_cast<long>(b) * S + (rank * 16 + warp) * 3;\n"
     "    out[0] = c_pass;\n    out[1] = c_tail;\n    out[2] = c_sync;\n  }\n"
     "  if (rank != 0) return;\n\n  // the backtrace"),
]


def build(name, subs):
    """A copy of the kernels' source with ``subs`` applied, compiled as the
    port compiles its own; returns the bound library."""
    from gtn_applications_tpu_torch.ops import _build

    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_decode: the {name} copy no longer matches the source")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return _build._bind("sparse_scan", so)


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
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
    from gtn_applications_tpu_torch.ops.seglse_pallas import take

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a GPU")
    dev = torch.device("cuda")
    em, lens, table = cs.segmax_scan_inputs(torch, dev)
    plan = smp.decode_plan(table, em.shape[2], dev)
    tab = table.to(dev)
    batch = (em, take(smp._as2d(tab.weight), plan.main.order), tab.start.contiguous(),
             tab.accept.contiguous(), lens, plan)
    one = (em[:1].contiguous(),) + batch[1:4] + (lens[:1].contiguous(), plan)
    cases = {"B32": batch, "B1": one}
    result = {"card": utils.card_name_and_power_limit(), "shape": list(em.shape),
              "choose_cluster": smp.choose_cluster(plan, em.shape[0], dev), "clusters": {}}

    def times(ks):
        return {f"k{k}_{name}": cs.gpu_median_ms(
            torch, lambda k=k, a=a: smp.seg_max_scan_cuda(*a, cluster=k))
            for k in ks for name, a in cases.items()}

    for k in ssp.CLUSTER_SIZES:
        sizes = ssp.plan_schedule(plan, k).sizes
        result["clusters"][k] = {"fit": smp.max_active_clusters(plan, k, dev),
                                 "tables_in_shared_memory": smp.decode_route(
                                     sizes, plan.S, plan.C)}
    result["ms"] = times(ssp.CLUSTER_SIZES)
    own = _build.load_library("sparse_scan")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["sparse_scan"] = build(name, subs)
            result[f"ms_{name}"] = times((4, 8))
        _build._libs["sparse_scan"] = build("clocks", CLOCKS)
        result["cycles_per_frame"] = {}
        for k in (2, 4, 8):
            for name, a in cases.items():
                _, final, _, _ = smp.seg_max_scan_cuda(*a, cluster=k)
                frames = a[4].cpu().numpy().astype(np.float64)[:, None, None, None]
                c = final.cpu().numpy()[:, :k * 16 * 3].reshape(-1, k, 16, 3) / frames
                result["cycles_per_frame"][f"k{k}_{name}"] = {
                    "pass_slowest_warp": c[..., 0].max(-1).mean(0).round().tolist(),
                    "pass_mean_warp": c[..., 0].mean(-1).mean(0).round().tolist(),
                    "after_pass": c[..., 1].mean(-1).mean(0).round().tolist(),
                    "barrier": c[..., 2].mean(-1).mean(0).round().tolist()}
    finally:
        _build._libs["sparse_scan"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_decode": result}, default=lambda x: float(np.asarray(x)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
