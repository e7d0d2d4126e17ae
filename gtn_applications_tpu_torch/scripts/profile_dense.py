"""Where the dense scan pair's time goes (``dense_scan_fwd`` and
``dense_scan_bwd``, csrc/dense_scan.cu).

    python -m gtn_applications_tpu_torch.scripts.profile_dense [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernels by parts itself, at the STC headline (B=32,
T=250, S=96) and at the word decompositions of the 1k inventory (B=32,
T=100, S=376), two of ``chip_smoke.dense_time_cases``:

- the pair (CUDA-event medians of 30, ``chip_smoke.gpu_median_ms``), the
  backward without dadj;
- copies of ``csrc/dense_scan.cu`` with one part changed, built into
  ``build/profile_dense`` and timed the same way: no frames at all
  (``no_frames``: the prologues, the statistics pass and the tails), no
  statistics pass frames (``no_stats``), no exp in the forward's arc terms
  (``no_exp``), no log (``no_log``), no traj store (``no_traj_store``), no
  redux of the warps' maxima (``no_redux``), no exp in the chain
  (``no_chain_exp``).  Their results are wrong; only their times mean
  something;
- a copy that counts ``clock64`` cycles in the forward: the prologue by
  part (member compaction, degrees and offsets, the plan, the arc fill and
  the staged rows' wait), the frames, and per frame each frame warp's pass
  and its wait in the barrier, averaged over the samples' live frames (and
  over the samples that have the warp); and one that splits the chain's
  frame by warp into its pass (the source warps' sums and dem stores, the
  side warp's ring copy and wait) and its barrier wait.

One JSON line (also written to FILE) with the card's name and power
limit.  Run from the root of a checkout on a machine with one GPU.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "gtn_applications_tpu_torch" / "ops" / "csrc" / "dense_scan.cu"
OUT_DIR = ROOT / "build" / "profile_dense"

FWD_LOOP = "  for (int t = 0; t < frames; ++t) {\n"
CHAIN_LOOP = "  for (int f = 0; f < nf; ++f) {\n"
STATS_LOOP = "  for (int t = t0 + warp; t < t1; t += kFactWarps) {\n"
FWD_END = ("    if (!a.staged) wait_ring();\n"
           "    frame_sync(threads);  // next and the maxima complete, row t + 1 landed\n  }\n")
CHAIN_END = "    frame_sync(threads);  // gnext complete, the next ring rows landed\n  }\n"
VARIANTS = {
    "no_frames": [(FWD_LOOP, "  for (int t = 0; t < 0; ++t) {\n"),
                  (CHAIN_LOOP, "  for (int f = 0; f < 0; ++f) {\n"),
                  (STATS_LOOP, "  for (int t = t1; t < t1; t += kFactWarps) {\n")],
    "no_stats": [(STATS_LOOP, "  for (int t = t1; t < t1; t += kFactWarps) {\n")],
    "no_exp": [("            z += l.av[k] * (f0 ? xs : exp_ftz(xs - sh));",
                "            z += l.av[k] * (f0 ? xs : xs - sh);")],
    "no_log": [("  const float lz = logf(fmaxf(z, kFloor));", "  const float lz = z;")],
    "no_traj_store": [("    tr_t[u] = v;\n    next[u] = v;", "    next[u] = v;")],
    "no_redux": [("    wm = warp_max(wm);\n", "")],
    "no_chain_exp": [("          const float e = l.s < S ? exp_ftz(prev[l.s] - sh) : 0.0f;",
                      "          const float e = l.s < S ? prev[l.s] - sh : 0.0f;")],
}
# the forward's prologue by part and its frames (thread 0, into traj[b, 0,
# :7]), and per frame warp its pass and its barrier wait (lane 0, into
# traj[b, 1, 2 w ..]); the frozen tail is left out
CLOCKS = [
    ("  const FactSmem lay = fact_layout(S, 1, 1, dense_fwd_vec(S));\n",
     "  const FactSmem lay = fact_layout(S, 1, 1, dense_fwd_vec(S));\n"
     "  const long long k0 = clock64();\n"),
    ("  const int frames = live_steps(lens[b], T);\n  dest_degrees(A, S, S_l, p, p.rnd);\n",
     "  const long long kc = clock64();\n"
     "  const int frames = live_steps(lens[b], T);\n  dest_degrees(A, S, S_l, p, p.rnd);\n"),
    ("  const int arena = smem_words - lay.arena;\n  const int nnz = p.arc_ptr[S_l];\n",
     "  const long long ko = clock64();\n"
     "  const int arena = smem_words - lay.arena;\n  const int nnz = p.arc_ptr[S_l];\n"),
    ("  const int staged = p.misc[kStaged], warps = p.misc[kWarps];\n",
     "  const long long kp = clock64();\n"
     "  const int staged = p.misc[kStaged], warps = p.misc[kWarps];\n"),
    ("  float* tr_b = traj + static_cast<long>(b) * T * S;\n  const DenseFwdArgs args{",
     "  const long long k1 = clock64();\n"
     "  float* tr_b = traj + static_cast<long>(b) * T * S;\n  const DenseFwdArgs args{"),
    ("    for (int t = p.jslot[s] < 0 ? 0 : frames; t < T; ++t) tr_b[static_cast<long>(t) * S + s] = v;\n"
     "  }\n}",
     "    (void)v;\n  }\n  const long long k2 = clock64();\n  frame_sync(32 * warps);\n"
     "  if (threadIdx.x == 0) {\n    tr_b[0] = k1 - k0;\n    tr_b[1] = k2 - k1;\n"
     "    tr_b[3] = kc - k0;\n    tr_b[4] = ko - kc;\n    tr_b[5] = kp - ko;\n"
     "    tr_b[6] = k1 - kp;\n  }\n}"),
    (FWD_LOOP, "  long long c_pass = 0, c_sync = 0;\n" + FWD_LOOP
     + "    const long long c0 = clock64();\n"),
    (FWD_END, "    if (!a.staged) wait_ring();\n    const long long c1 = clock64();\n"
     "    frame_sync(threads);  // next and the maxima complete, row t + 1 landed\n"
     "    c_pass += c1 - c0;\n    c_sync += clock64() - c1;\n  }\n"
     "  frame_sync(threads);\n  if (lane == 0) {\n"
     "    a.tr_b[S + 2 * warp] = c_pass;\n    a.tr_b[S + 2 * warp + 1] = c_sync;\n  }\n"),
]
# the chain, per warp and frame: its pass (the source warps' sums and dem
# stores, the side warp's ring copy and wait) and its barrier wait, into
# dem[b, 0, 2 w ..] after frame 0 (the side warp last)
CHAIN_CLOCKS = [
    (CHAIN_LOOP, "  long long ck[2] = {0, 0};\n" + CHAIN_LOOP
     + "    const long long c0 = clock64();\n"),
    (CHAIN_END, "    const long long c1 = clock64();\n"
     "    frame_sync(threads);  // gnext complete, the next ring rows landed\n"
     "    ck[0] += c1 - c0;\n    ck[1] += clock64() - c1;\n  }\n"
     "  if (lane == 0)\n    for (int q = 0; q < 2; ++q)\n"
     "      reinterpret_cast<float*>(p.rnd)[2 * warp + q] = ck[q];\n"),
    ("  for (int u = threadIdx.x; u < S; u += 32 * (warps + 1)) dense_dem(c, 0, u, gfin[u], c.rz_b[u]);\n}",
     "  for (int u = threadIdx.x; u < S; u += 32 * (warps + 1)) dense_dem(c, 0, u, gfin[u], c.rz_b[u]);\n"
     "  frame_sync(32 * (warps + 1));\n"
     "  for (int q = threadIdx.x; q < 2 * (warps + 1); q += 32 * (warps + 1))\n"
     "    c.dem_b[q] = reinterpret_cast<float*>(p.rnd)[q];\n}"),
]

def patched(name, subs):
    """The kernels' source with ``subs`` applied, each of which must match
    exactly once."""
    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_dense: the {name} copy no longer matches the source")
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
    return _build._bind("dense_scan", so)


def by_warp(rows, warps, n, frames):
    """[warp, n] means a frame of the n numbers each warp wrote (rows[b,
    n w + i]), over the samples that have the warp (``warps[b]`` of them)."""
    import numpy as np

    w_max = max(warps)
    per = rows[:, :n * w_max].reshape(-1, w_max, n) / frames[:, None, None]
    per[np.arange(w_max)[None, :] >= np.asarray(warps)[:, None]] = np.nan
    return np.nanmean(per, axis=0)


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
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp

    if not torch.cuda.is_available():
        raise SystemExit("profile_dense needs a GPU")
    dev = torch.device("cuda")
    runs, cases = {}, {}
    for key, (em, adj, st, lab, acc, il) in cs.dense_time_cases(torch, dev):
        if key == "_s304":
            continue
        name = key.lstrip("_") or "headline"
        traj = dsp.dense_scan_fwd_plain(em, adj, st, lab, il)
        g = cs.score_cotangent(torch, traj[:, -1], acc)
        cases[name] = (em, adj, st, lab, il, traj, g)
        runs[name + "_fwd"] = lambda a=(em, adj, st, lab, il): dsp.dense_scan_fwd_cuda(*a)
        runs[name + "_bwd"] = (lambda a=(traj, adj, st, lab, il, g):
                               dsp.dense_scan_bwd_cuda(*a, need_dadj=False))

    def times():
        return {name: cs.gpu_median_ms(torch, run) for name, run in runs.items()}

    result = {"card": utils.card_name_and_power_limit(), "ms": times(),
              "routes": {name: cs.dense_routes(torch, c[1], c[3], c[4])
                         for name, c in cases.items()}}
    own = _build.load_library("dense_scan")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["dense_scan"] = build(name, subs)
            result[f"ms_{name}"] = times()
            print(name, result[f"ms_{name}"], flush=True)
        _build._libs["dense_scan"] = build("clocks", CLOCKS)
        result["cycles"] = {}
        for name, (em, adj, st, lab, il, _, _) in cases.items():
            tr = dsp.dense_scan_fwd_cuda(em, adj, st, lab, il).cpu().numpy().astype(np.float64)
            frames = il.clamp(min=1).cpu().numpy().astype(np.float64)
            per = by_warp(tr[:, 1], [p["warps"] for p in dsp.dense_plan(adj, lab, il)], 2,
                          frames)
            result["cycles"][name] = {
                "prologue": float(tr[:, 0, 0].mean()),
                "frames": float(tr[:, 0, 1].mean()),
                "prologue_parts": {k: float(tr[:, 0, i].mean()) for i, k in enumerate(
                    ("compact", "degrees_offsets", "plan", "fill_rows"), 3)},
                "pass_by_warp": per[..., 0].round().tolist(),
                "barrier_by_warp": per[..., 1].round().tolist()}
        print(result["cycles"], flush=True)
        _build._libs["dense_scan"] = build("chain_clocks", CHAIN_CLOCKS)
        result["chain_cycles"] = {}
        for name, (em, adj, st, lab, il, traj, g) in cases.items():
            dem = dsp.dense_scan_bwd_cuda(traj, adj, st, lab, il, g,
                                          need_dadj=False)[0].cpu().numpy().astype(np.float64)
            frames = (il.clamp(min=2) - 1).cpu().numpy().astype(np.float64)
            per = by_warp(dem[:, 0],
                          [p["chain_warps"] + 1 for p in dsp.dense_plan(adj, lab, il)], 2, frames)
            result["chain_cycles"][name] = {
                "pass_barrier_by_warp_side_last": per.round().tolist()}
        print(result["chain_cycles"], flush=True)
    finally:
        _build._libs["dense_scan"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_dense": result}, default=lambda x: float(np.asarray(x)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
