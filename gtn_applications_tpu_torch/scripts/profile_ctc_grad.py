"""Where a frame of the CTC backward (``ctc_grad``, csrc/ctc.cu) goes.

    python -m gtn_applications_tpu_torch.scripts.profile_ctc_grad [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernel by parts itself, at the three shapes
``chip_smoke.py`` times it, the CTC headline (B=32, T=250, L=44: S=89) and
``chip_smoke.CTC_WIDE`` (B=8, T=300, S=241, and B=8, T=500, S=401), all on
route "block" (3, 8 and 13 warps), and at B=32, T=250, L=11 (S=23, route
"warp"):

- the kernel (CUDA-event medians of 30, ``chip_smoke.gpu_median_ms``) and
  the chain bound (the longest sample's frames less one x one frame of
  ``ctc_chain_probe``);
- the registers and spills of each of its kernels and of the forward's
  (``ctc_alpha``; ``nvcc -Xptxas -v``) and their instructions as compiled
  (``cuobjdump -sass``, where the toolkit has it): calls, branches, MUFU,
  shuffles, loads and stores;
- copies of ``csrc/ctc.cu`` with one part changed, built into
  ``build/profile_ctc_grad`` and timed the same way: no posterior store
  (``no_post``: the helper warp's on route "warp"), the chain warp's
  neighbours its own values, no shuffles (``no_exchange``), no barrier on
  route "block" (``no_barrier``), whose results are wrong; and three that
  change a choice of the design, whose results stay: route "block" without
  its ring, em and alpha loaded from global memory two frames ahead
  (``block_no_ring``), and the boundary between the routes at 128 states
  and at none (``warp_up_to_128``: the headline on the chain and helper
  warps, K=3; ``no_warp``: S=23 on route "block", one warp), and one
  without the select of 0 for a label outside [0, C) at the register load
  of em (``no_select``: every label of these cases lies inside);
- a copy that counts ``clock64`` cycles a frame (route "warp": the helper
  warp's loop, which follows the chain a frame at a time; route "block":
  thread 0's loop, the ring's copies and reads included),
  averaged over the samples' live frames.

One JSON line (also written to FILE) with the card's name and power
limit.  Run from the root of a checkout on a machine with one GPU.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "gtn_applications_tpu_torch" / "ops" / "csrc" / "ctc.cu"
OUT_DIR = ROOT / "build" / "profile_ctc_grad"

HELPER_STORE = ("      for (int j = 0; j < K; ++j) store_if(gr_t + lane + 32 * j, post[j], "
                "lane + 32 * j < S);\n")
BLOCK_POST = ("        store_if(gr_t + k * n, expf(fminf(a_r[q][k] + be[k] - sc, 0.0f)) * gb,\n"
              "                 (live >> k) & static_cast<unsigned>(t >= 0));\n")
BLOCK_LOOP = ("  for (int i0 = 0; i0 < t_live; i0 += kAhead) {\n#pragma unroll\n"
              "    for (int q = 0; q < kAhead; ++q) {\n      const int t = t_live - 1 - i0 - q;\n")
BLOCK_END = "      load(e_r[q], a_r[q], t - kAhead);\n    }\n  }\n}\n\n// Latency probe"
VARIANTS = {
    "no_post": [(HELPER_STORE, ""), (BLOCK_POST, "")],
    "no_exchange": [("        neighbours_above<K>(eb, jm, n1, n2, lane);\n",
                     "        for (int k = 0; k < K; ++k) {\n          n1[k] = eb[k];\n"
                     "          n2[k] = jm[k];\n        }\n")],
    "no_barrier": [("      __syncthreads();\n#pragma unroll\n", "#pragma unroll\n")],
    "block_no_ring": [("constexpr long kRingSmem = 200 * 1024;", "constexpr long kRingSmem = 0;")],
    "warp_up_to_128": [("constexpr int kWarpMaxS = 32;", "constexpr int kWarpMaxS = 128;")],
    "no_warp": [("constexpr int kWarpMaxS = 32;", "constexpr int kWarpMaxS = 0;")],
    "no_select": [("      e[k] = (inr >> k) & 1u ? v : 0.0f;\n      a[k] = kRinged",
                   "      e[k] = v;\n      a[k] = kRinged"),
                  ("      for (int k = 0; k < K; ++k) e[k] = (inr >> k) & 1u ? r[k] : 0.0f;",
                   "      for (int k = 0; k < K; ++k) e[k] = r[k];")],
}
# cycles a frame into the sample's grad[0, 0] (frames in grad[0, 1]): on
# route "warp" the helper's whole loop (it follows the chain warp a frame
# at a time), on route "block" thread 0's loop
CLOCKS = [
    ("    for (int i = 0; i < t_live; ++i) {\n      const int t = t_live - 1 - i, slot",
     "    const long long c_start = clock64();\n"
     "    for (int i = 0; i < t_live; ++i) {\n      const int t = t_live - 1 - i, slot"),
    (HELPER_STORE + "    }\n  }\n}\n",
     HELPER_STORE + "    }\n    if (lane == 0) {\n"
     "      gr_b[0] = static_cast<float>(clock64() - c_start);\n"
     "      gr_b[1] = static_cast<float>(t_live);\n    }\n  }\n}\n"),
    (BLOCK_LOOP, "  const long long c_start = clock64();\n" + BLOCK_LOOP),
    (BLOCK_END, "      load(e_r[q], a_r[q], t - kAhead);\n    }\n  }\n"
     "  if (tid == 0) {\n    gr_b[0] = static_cast<float>(clock64() - c_start);\n"
     "    gr_b[1] = static_cast<float>(t_live);\n  }\n}\n\n// Latency probe"),
]


def patched(name, subs):
    """The kernels' source with ``subs`` applied, each of which must match
    exactly once."""
    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_ctc_grad: the {name} copy no longer matches the source")
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
    return _build._bind("ctc", so)


def ptxas_info():
    """{kernel: "N registers, ..."} of the ctc_grad and ctc_alpha kernels
    as compiled (``nvcc -Xptxas -v``)."""
    from gtn_applications_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(OUT_DIR / "ptxas.so"), str(SOURCE)], capture_output=True,
                         text=True, check=True)
    out, name = {}, None
    for line in (run.stdout + run.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("ctc_grad_" in name or "ctc_alpha_kernel" in name) and (
                "registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def sass_counts(so):
    """{kernel: {mnemonic group: count}} of the ctc_grad and ctc_alpha
    kernels and the chain probe in the library ``so`` (``cuobjdump
    -sass``), or None where cuobjdump is missing: calls and branches split
    a frame's code into blocks the scheduler does not interleave; local
    loads and stores (LDL, STL) are spills."""
    import re

    from gtn_applications_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not any(k in name for k in ("ctc_grad_", "ctc_alpha_kernel", "chain_probe")):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part)
        key = re.search(r"ctc_(grad_warp|grad_block|alpha)_kernelILi(\d+)E", name)
        key = f"{key.group(1)}_K{key.group(2)}_{len(out)}" if key else "probe"
        out[key] = {"total": len(ops), **{k: sum(o.startswith(k) for o in ops)
                                          for k in ("BRA", "CALL", "MUFU", "SHFL", "LDS", "LDG",
                                                    "STG", "LDGSTS", "BAR", "LDL", "STL")}}
        out[key]["LDG"] -= out[key]["LDGSTS"]
    return out


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
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp

    if not torch.cuda.is_available():
        raise SystemExit("profile_ctc_grad needs a GPU")
    dev = torch.device("cuda")
    cases = {}
    for i, (b, t, l) in enumerate(((cs.B, cs.T, cs.L),) + cs.CTC_WIDE + ((cs.B, cs.T, 11),)):
        logp, labels, start, accept, skip, il, g = cs.ctc_case(torch, dev, b, t, l,
                                                               seed=i + 1 if i else 0)
        alpha = lp.ctc_alpha_cuda(logp, labels, start, skip, il)
        cases[f"S{labels.shape[1]}"] = (logp, labels, alpha, accept, skip, il,
                                        lp._final_score(alpha[:, -1], accept), g)

    def times():
        return {name: cs.gpu_median_ms(torch, lambda c=c: lp.ctc_grad_cuda(*c))
                for name, c in cases.items()}

    want = {name: lp.ctc_grad_cuda(*c) for name, c in cases.items()}
    result = {"card": utils.card_name_and_power_limit(), "ms": times(),
              "plans": {name: lp.grad_plan(c[1].shape[1]) for name, c in cases.items()},
              "ptxas": ptxas_info(), "sass": sass_counts(_build._target("ctc")[1])}
    frame_us = cs.ctc_chain_frame_us(torch, dev)
    result["chain_frame_us"] = frame_us
    result["chain_bound_ms"] = {name: (int(c[5].max()) - 1) * frame_us * 1e-3
                                for name, c in cases.items()}
    own = _build.load_library("ctc")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["ctc"] = build(name, subs)
            result[f"ms_{name}"] = times()
            if name in ("block_no_ring", "warp_up_to_128", "no_warp", "no_select"):
                # results stay (no_select: every label of these cases is in range)
                result[f"{name}_bitwise"] = {
                    case: bool(torch.equal(lp.ctc_grad_cuda(*c), want[case]))
                    for case, c in cases.items()}
            print(name, result[f"ms_{name}"], flush=True)
        _build._libs["ctc"] = build("clocks", CLOCKS)
        result["cycles_per_frame"] = {}
        for name, c in cases.items():
            gr = lp.ctc_grad_cuda(*c)[:, 0, :2].cpu().numpy().astype(np.float64)
            live = gr[:, 1] > 0
            result["cycles_per_frame"][name] = float((gr[live, 0] / gr[live, 1]).mean())
        print(result["cycles_per_frame"], flush=True)
    finally:
        _build._libs["ctc"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_ctc_grad": result}, default=lambda x: float(np.asarray(x)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
