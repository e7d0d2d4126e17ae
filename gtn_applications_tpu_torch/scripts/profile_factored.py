"""Where the factored scan pair's time goes (``factored_scan_fwd`` and
``factored_scan_bwd``, csrc/dense_scan.cu).

    python -m gtn_applications_tpu_torch.scripts.profile_factored [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernels by parts itself, on the bigram Transducer's
lattices at the ngram-2 headline and at the IAM width
(``chip_smoke.factored_headline_inputs``: B=32, T=250, S=96 and 136):

- the pair (CUDA-event medians of 30, ``chip_smoke.gpu_median_ms``), the
  backward without dadj;
- copies of ``csrc/dense_scan.cu`` with one part changed, built into
  ``build/profile_factored`` and timed the same way: no frames at all
  (``no_frames``: the prologues, the statistics pass and the tails), no
  shift in the forward (``no_shift``), no exp in the forward's and the
  statistics' arc terms (``no_dest_exp``), no log (``no_log``), no traj
  store (``no_traj_store``), no exp in the chain's terms
  (``no_chain_exp``), no statistics pass frames (``no_stats``).  Their
  results are wrong; only their times mean something;
- a copy that counts ``clock64`` cycles in the forward: the prologue (to
  the first frame, by part: label compaction, degrees and offsets, the
  plan, the arc and label-column fill), the tail (the frozen frames' and
  unlabelled states' stores) and, per frame, each warp's pass and its
  wait in the barrier, averaged over the samples' live frames; one that
  splits a registers-route round into its shift, its arcs and the new
  alpha; and one that splits the chain's frame into the ring row's copy,
  the dem stores, the sparse product, the ring wait and the barrier, by
  warp.

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
OUT_DIR = ROOT / "build" / "profile_factored"

FWD_LOOP = "  for (int t = 0; t < a.t_live; ++t) {\n"
CHAIN_LOOP = "  for (int i = 0; i < nf; ++i) {\n"
STATS_LOOP = "  for (int t = t0 + warp; t < t1; t += blockDim.x >> 5) {\n"
VARIANTS = {
    "no_frames": [(FWD_LOOP, "  for (int t = 0; t < 0; ++t) {\n"),
                  (CHAIN_LOOP, "  for (int i = 0; i < 0; ++i) {\n"),
                  (STATS_LOOP, "  for (int t = t1; t < t1; t += blockDim.x >> 5) {\n")],
    "no_stats": [(STATS_LOOP, "  for (int t = t1; t < t1; t += blockDim.x >> 5) {\n")],
    "no_shift": [("    sh = __shfl_sync(kFull, group_shift<K>(x, p.wt, q.wr, q.tk, a.S, lane), "
                  "8 * q.tk.k);", "    sh = x[lane];")],
    "no_log": [("      v = em + (z >= kTiny ? sh + logf(fmaxf(z, kFloor)) : kNeg);",
                "      v = em + (z >= kTiny ? sh + z : kNeg);")],
    "no_traj_store": [("    next[u] = v;\n    tr_t[u] = v;", "    next[u] = v;")],
    "no_dest_exp": [("    const float e = frame0 ? x[s] : exp_ftz((kLabels ? x[s] + wcol[s] : x[s]) - sh);",
                     "    const float e = frame0 ? x[s] : (kLabels ? x[s] + wcol[s] : x[s]) - sh;"),
                    ("    const float e = f0 ? x[q.xs[k]] : exp_ftz((x[q.xs[k]] + q.wv[k]) - sh);",
                     "    const float e = f0 ? x[q.xs[k]] : (x[q.xs[k]] + q.wv[k]) - sh;")],
    "no_chain_exp": [("  const float e = exp_ftz((ps + wt[j * S + s]) - shr[j]);",
                      "  const float e = (ps + wt[j * S + s]) - shr[j];")],
}
# the forward's prologue, and per warp and frame its pass and its barrier;
# written into traj[b, 0, :] (thread 0: prologue) and traj[b, 1, 2 w ..]
CLOCKS = [
    (" int fact_smem[];\n  const FactSmem lay = fact_layout(S, N, L, 3 * S);\n",
     " int fact_smem[];\n  const FactSmem lay = fact_layout(S, N, L, 3 * S);\n"
     "  const long long k0 = clock64();\n"),
    ("  if (p.misc[kRoute] != kRouteRegisters)\n    fwd_frames<0>(p, args);",
     "  const long long k1 = clock64();\n"
     "  if (p.misc[kRoute] != kRouteRegisters)\n    fwd_frames<0>(p, args);"),
    (FWD_LOOP, "  long long c_pass = 0, c_sync = 0;\n" + FWD_LOOP
     + "    const long long c0 = clock64();\n"),
    ("    if (!a.staged) wait_ring();\n    __syncthreads();  // next complete, row t + 1 landed\n  }\n",
     "    if (!a.staged) wait_ring();\n    const long long c1 = clock64();\n"
     "    __syncthreads();  // next complete, row t + 1 landed\n"
     "    c_pass += c1 - c0;\n    c_sync += clock64() - c1;\n  }\n"
     "  __syncthreads();\n  if (lane == 0) {\n"
     "    a.tr_b[S + 2 * warp] = c_pass;\n    a.tr_b[S + 2 * warp + 1] = c_sync;\n  }\n"),
    ("tr_s[static_cast<long>(t) * S] = v;\n  }\n}",
     "tr_s[static_cast<long>(t) * S] = v;\n  }\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n    tr_b[0] = k1 - k0;\n"
     "    tr_b[1] = clock64() - k2;\n    tr_b[3] = kc - k0;\n    tr_b[4] = ko - kc;\n"
     "    tr_b[5] = kp - ko;\n    tr_b[6] = k1 - kp;\n  }\n}"),
    ("  const int t_live = live_steps(lens[b], T);\n  dest_degrees(A, S, S_l, p, p.rnd);\n",
     "  const long long kc = clock64();\n"
     "  const int t_live = live_steps(lens[b], T);\n  dest_degrees(A, S, S_l, p, p.rnd);\n"),
    ("  hub = __syncthreads_or(hub);\n",
     "  hub = __syncthreads_or(hub);\n  const long long ko = clock64();\n"),
    ("  __syncthreads();\n  const bool dense = p.misc[kRoute] == kRouteGlobal;\n  const int staged",
     "  __syncthreads();\n  const long long kp = clock64();\n"
     "  const bool dense = p.misc[kRoute] == kRouteGlobal;\n  const int staged"),
    ("  __pipeline_wait_prior(0);\n  // states without a label stay NEG",
     "  const long long k2 = clock64();\n"
     "  __pipeline_wait_prior(0);\n  // states without a label stay NEG"),
]

# the forward's registers route, per warp and frame: its round's shift,
# its arcs (to the merged z) and the new alpha; written into traj[b, 2, :]
ROUND_CLOCKS = [
    ("                                               const float* em_row, float* next, float* tr_t,\n"
     "                                               int lane) {\n  float sh = 0.0f;\n",
     "                                               const float* em_row, float* next, float* tr_t,\n"
     "                                               int lane, long long* ck) {\n"
     "  const long long k0 = clock64();\n  float sh = 0.0f;\n"),
    ("  float z = 0.0f;\n#pragma unroll\n  for (int k = 0; k < kCap; ++k) {\n",
     "  const long long k1 = clock64();\n"
     "  float z = 0.0f;\n#pragma unroll\n  for (int k = 0; k < kCap; ++k) {\n"),
    ("  emit_alpha(q.tk.u, q.tk.g, z, sh, f0, emission(q.tk.u, f0, em_row, a.ws_b), next, tr_t,\n"
     "             lane);\n}",
     "  const long long k2 = clock64();\n"
     "  emit_alpha(q.tk.u, q.tk.g, z, sh, f0, emission(q.tk.u, f0, em_row, a.ws_b), next, tr_t,\n"
     "             lane);\n"
     "  __syncwarp();\n  ck[0] += k1 - k0;\n  ck[1] += k2 - k1;\n  ck[2] += clock64() - k2;\n}"),
    ("      if (rb < re) fwd_round_regs(p, a, q, x, f0, em_row, next, tr_t, lane);",
     "      if (rb < re) fwd_round_regs(p, a, q, x, f0, em_row, next, tr_t, lane, ck);"),
    ("  RegRound<(K > 0 ? K : 1)> q;\n",
     "  RegRound<(K > 0 ? K : 1)> q;\n  long long ck[3] = {0, 0, 0};\n"),
    ("    if (!a.staged) wait_ring();\n    __syncthreads();  // next complete, row t + 1 landed\n  }\n",
     "    if (!a.staged) wait_ring();\n    __syncthreads();  // next complete, row t + 1 landed\n  }\n"
     "  __syncthreads();\n  if (lane == 0)\n"
     "    for (int i = 0; i < 3; ++i) a.tr_b[2 * S + 3 * warp + i] = ck[i];\n"),
]

# the chain, per warp and frame: the ring row's copy, the dem stores, the
# sparse product, the ring wait and the barrier; written into dws[b, :]
CHAIN_CLOCKS = [
    ("  wait_ring();\n  __syncthreads();  // the first ring row\n",
     "  wait_ring();\n  __syncthreads();  // the first ring row\n"
     "  long long ck[5] = {0, 0, 0, 0, 0};\n"),
    ("    fetch_chain_row(c, i + kRing - 1);\n    float* dem_t",
     "    const long long k0 = clock64();\n    fetch_chain_row(c, i + kRing - 1);\n"
     "    const long long k1 = clock64();\n    float* dem_t"),
    ("        c.dz_b[static_cast<long>(t) * S + u] = ga * zr[u];\n    }\n",
     "        c.dz_b[static_cast<long>(t) * S + u] = ga * zr[u];\n    }\n"
     "    const long long k2 = clock64();\n"),
    ("    wait_ring();\n    __syncthreads();  // gnext complete, the next ring row landed\n  }\n",
     "    const long long k3 = clock64();\n    wait_ring();\n    const long long k4 = clock64();\n"
     "    __syncthreads();  // gnext complete, the next ring row landed\n"
     "    ck[0] += k1 - k0;\n    ck[1] += k2 - k1;\n    ck[2] += k3 - k2;\n"
     "    ck[3] += k4 - k3;\n    ck[4] += clock64() - k4;\n  }\n"
     "  if (lane == 0)\n    for (int q = 0; q < 5; ++q) c.ck_out[5 * warp + q] = ck[q];\n"),
    ("  float* dz_b;  // null unless dadj is asked for\n",
     "  float* dz_b;  // null unless dadj is asked for\n  float* ck_out;\n"),
    ("  const ChainArgs c{tr_b, sh_s + static_cast<long>(b) * T * L,\n",
     "  float* ckbuf = reinterpret_cast<float*>(p.rnd);\n"
     "  const ChainArgs c{tr_b, sh_s + static_cast<long>(b) * T * L,\n"),
    ("                    dz_s ? dz_s + static_cast<long>(b) * T * S : nullptr,\n",
     "                    dz_s ? dz_s + static_cast<long>(b) * T * S : nullptr, ckbuf,\n"),
    ("      dw_b[static_cast<long>(s) * N + p.label_of[j]] = sum;\n    }\n  }\n}",
     "      dw_b[static_cast<long>(s) * N + p.label_of[j]] = sum;\n    }\n  }\n"
     "  __syncthreads();\n"
     "  for (int q = threadIdx.x; q < 5 * kFactWarps; q += blockDim.x)\n"
     "    dws[static_cast<long>(b) * S + q] = ckbuf[q];\n}"),
]


def build(name, subs):
    """A copy of the kernels' source with ``subs`` applied, compiled as the
    port compiles its own; returns the bound library."""
    from gtn_applications_tpu_torch.ops import _build

    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_factored: the {name} copy no longer matches the source")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return _build._bind("dense_scan", so)


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
        raise SystemExit("profile_factored needs a GPU")
    dev = torch.device("cuda")
    runs, cases = {}, {}
    for name in ("ngram2", "iam"):
        em, adj, wsel, lab, ws, st, acc, il = cs.factored_headline_inputs(
            torch, dev, **cs.NGRAM_CASES[name])
        traj = dsp.factored_scan_fwd_plain(em, adj, wsel, lab, ws, st, il)
        g = cs.score_cotangent(torch, traj[:, -1], acc)
        cases[name] = (em, adj, wsel, lab, ws, st, il)
        runs[name + "_fwd"] = (lambda a=(em, adj, wsel, lab, ws, st, il):
                               dsp.factored_scan_fwd_cuda(*a))
        runs[name + "_bwd"] = (lambda a=(traj, adj, wsel, lab, st, il, g):
                               dsp.factored_scan_bwd_cuda(*a, need_dadj=False))

    def times():
        return {name: cs.gpu_median_ms(torch, run) for name, run in runs.items()}

    result = {"card": utils.card_name_and_power_limit(), "ms": times()}
    own = _build.load_library("dense_scan")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["dense_scan"] = build(name, subs)
            result[f"ms_{name}"] = times()
            print(name, result[f"ms_{name}"], flush=True)
        _build._libs["dense_scan"] = build("round_clocks", ROUND_CLOCKS)
        result["round_cycles"] = {}
        for name, a in cases.items():
            tr = dsp.factored_scan_fwd_cuda(*a).cpu().numpy().astype(np.float64)
            frames = a[6].clamp(min=1).cpu().numpy().astype(np.float64)
            per = tr[:, 2, :3 * dsp.FACT_WARPS].reshape(-1, dsp.FACT_WARPS, 3)
            per = per / frames[:, None, None]
            result["round_cycles"][name] = {
                "shift_arcs_emit_by_warp": per.mean(0).round().tolist()}
        print(result["round_cycles"], flush=True)
        _build._libs["dense_scan"] = build("chain_clocks", CHAIN_CLOCKS)
        result["chain_cycles"] = {}
        for name, a in cases.items():
            traj = dsp.factored_scan_fwd_plain(*a)
            g = torch.ones_like(traj[:, -1])
            dws = dsp.factored_scan_bwd_cuda(traj, a[1], a[2], a[3], a[5], a[6], g,
                                             need_dadj=False)[3].cpu().numpy()
            frames = (a[6].clamp(min=2) - 1).cpu().numpy().astype(np.float64)
            per = dws[:, :5 * dsp.FACT_WARPS].reshape(-1, dsp.FACT_WARPS, 5) / frames[:, None, None]
            result["chain_cycles"][name] = {
                "copy_dem_sum_wait_barrier_by_warp": per.mean(0).round().tolist()}
        print(result["chain_cycles"], flush=True)
        _build._libs["dense_scan"] = build("clocks", CLOCKS)
        result["cycles"] = {}
        for name, a in cases.items():
            tr = dsp.factored_scan_fwd_cuda(*a).cpu().numpy().astype(np.float64)
            frames = a[6].clamp(min=1).cpu().numpy().astype(np.float64)
            per = tr[:, 1, :2 * dsp.FACT_WARPS].reshape(
                -1, dsp.FACT_WARPS, 2) / frames[:, None, None]
            result["cycles"][name] = {
                "prologue": float(tr[:, 0, 0].mean()),
                "tail": float(tr[:, 0, 1].mean()),
                "prologue_parts": {k: float(tr[:, 0, i].mean()) for i, k in enumerate(
                    ("compact", "degrees_offsets", "plan", "fill"), 3)},
                "pass_by_warp": per[..., 0].mean(0).round().tolist(),
                "barrier_by_warp": per[..., 1].mean(0).round().tolist()}
    finally:
        _build._libs["dense_scan"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_factored": result}, default=lambda x: float(np.asarray(x)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
