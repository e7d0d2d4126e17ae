"""Where a frame of the whole-scan Viterbi (``viterbi_scan_fwd``) goes.

    python -m gtn_applications_tpu_torch.scripts.profile_viterbi [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernel by parts itself, at two tables: the decode
headline (``chip_smoke.viterbi_headline_inputs``: B=32, T=250, C=80,
S=82, 6,480 arcs) and the backoff trigram path's decode table
(``compare_sparse_scan.trigram_decode_inputs``: B=32, T=576, C=12, S=95,
1,932 arcs), each by the route the kernel takes there:

- the kernel (CUDA-event medians of 30, ``chip_smoke.gpu_median_ms``);
- the instructions of each route's kernel as compiled (``cuobjdump
  -sass``, where the toolkit has it), the scan alone and with each walk:
  shared, generic and local loads, branches, shuffles and the total;
- copies of ``csrc/viterbi.cu`` with one part of the frame changed,
  built into ``build/profile_viterbi`` and timed the same way: no slot
  store (``no_slot_store``), no shared-memory load in the relaxation
  (``no_shared_loads``), no shuffle merge (``no_merge``); and three that
  undo a step of the design: the emission rows through the 8-row ring
  where all of them fit (``ring_rows``), the emissions read from global
  memory on the frame's chain, not from shared memory
  (``em_from_global``), and a second block barrier a frame
  (``two_barriers``).  The first three copies' results are wrong; only
  their times mean something;
- a copy that counts ``clock64`` cycles in each warp per frame: the pass
  over its slots, what follows up to the barrier (the row wait), and the
  barrier; averaged over the samples' live frames, by warp.

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
OUT_DIR = ROOT / "build" / "profile_viterbi"

RELAX = "    const float c = (at(prev, so[j]) + wv[j]) + at(em_row, lo[j]);"
MERGE = ("  for (int off = ln.g >> 1; off > 0; off >>= 1)\n"
         "    max_merge(best, bd, __shfl_xor_sync(kFull, best, off), "
         "__shfl_xor_sync(kFull, bd, off));\n")
VARIANTS = {
    "no_slot_store": [("      slot_t[s] = v > kNeg ? d : kDead;\n", "")],
    "ring_rows": [("  const bool in_ring = rows < T;", "  const bool in_ring = true;")],
    "no_shared_loads": [(RELAX, "    const float c = (__uint_as_float(so[j]) + wv[j]) + "
                                "__uint_as_float(lo[j]);")],
    "no_merge": [(MERGE, "")],
    "em_from_global": [("  const float* em_row = ring + (in_ring ? t % kRing : t) * C;\n",
                        "  const float* em_row = em_b + static_cast<long>(t) * C;\n")],
    "two_barriers": [("    // the ring slot of row t - 1, read in frame t - 1",
                      "    __syncthreads();\n    // the ring slot of row t - 1, read in frame t - 1")],
}
# per warp and frame: the pass over its slots, what follows up to the
# barrier, and the barrier; written into final_alpha at the end
CLOCKS = [
    ("  for (int t = 0; t < t_live; ++t, slot_t += S) {\n    const float* prev",
     "  long long c_pass = 0, c_tail = 0, c_sync = 0;\n"
     "  for (int t = 0; t < t_live; ++t, slot_t += S) {\n    const long long c0 = clock64();\n"
     "    const float* prev"),
    ("    if (nhubs > 0) {\n      __syncthreads();  // the hub chunks' parts",
     "    const long long c1 = clock64();\n"
     "    if (nhubs > 0) {\n      __syncthreads();  // the hub chunks' parts"),
    ("    if (in_ring) wait_rows();\n    __syncthreads();  // next complete, row t + 1 landed\n  }",
     "    if (in_ring) wait_rows();\n    const long long c2 = clock64();\n"
     "    __syncthreads();  // next complete, row t + 1 landed\n"
     "    c_pass += c1 - c0;\n    c_tail += c2 - c1;\n    c_sync += clock64() - c2;\n  }"),
    ("    final_alpha[static_cast<long>(b) * S + s] = fin[s];\n  if constexpr (!kWords) return;\n",
     "    final_alpha[static_cast<long>(b) * S + s] = fin[s];\n  __syncthreads();\n"
     "  if (lane == 0) {\n    float* out = final_alpha + static_cast<long>(b) * S + 3 * warp;\n"
     "    out[0] = c_pass;\n    out[1] = c_tail;\n    out[2] = c_sync;\n  }\n"
     "  if constexpr (!kWords) return;\n"),
]


def build(name, subs):
    """A copy of the kernels' source with ``subs`` applied, compiled as the
    port compiles its own; returns the bound library."""
    from gtn_applications_tpu_torch.ops import _build

    src = SOURCE.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_viterbi: the {name} copy no longer matches the source")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return _build._bind("viterbi", so)


def sass_counts(so):
    """{kernel: {mnemonic group: count}} of the scan kernels in the library
    ``so`` (``cuobjdump -sass``), or None where cuobjdump is missing."""
    import re

    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.ops.viterbi_scan_pallas import ROUTES, WALKS

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "viterbi_scan_fwd_kernel" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part)
        route, walk = (int(x) for x in re.search(r"ILi(\d)ELi(\d)E", name).groups())
        route = f"{ROUTES[route]}/walk {(None, *WALKS)[walk]}"  # the kernel's template values
        out[route] = {"total": len(ops), **{k: sum(o.startswith(k) for o in ops)
                                            for k in ("LDS", "LDL", "LD", "STL", "BRA", "SHFL",
                                                      "BAR")}}
        out[route]["LD"] -= out[route]["LDS"] + out[route]["LDL"]  # generic and global
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
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.scripts.compare_sparse_scan import trigram_decode_inputs

    if not torch.cuda.is_available():
        raise SystemExit("profile_viterbi needs a GPU")
    dev = torch.device("cuda")
    head = cs.viterbi_headline_inputs(torch, dev, with_table=True)
    crit, em3, lens3 = trigram_decode_inputs(torch, cs, dev)
    cases = {"headline": (head[0], head[7], head[6]),
             "trigram": (em3, crit._decode_table(crit.params), lens3)}
    runs = {}
    result = {"card": utils.card_name_and_power_limit(), "cases": {}}
    for name, (em, table, lens) in cases.items():
        plan = vsp.build_plan(table)
        src_b, lab_b, w_b, start, _ = plan.to(dev)
        packed = plan.packed(dev)
        runs[name] = (lambda em=em, lens=lens, a=(src_b, lab_b, w_b, start), p=packed:
                      vsp.viterbi_scan_fwd_cuda(em, *a, lens, packed=p))
        result["cases"][name] = {
            "shape": list(em.shape), "S": plan.S, "A": packed.A, "cap": packed.cap,
            "warps": min(packed.slots, vsp.MAX_WARPS),
            "route": vsp.scan_route(packed, plan.S, em.shape[2]), "frames": int(lens.max())}

    def times():
        return {name: cs.gpu_median_ms(torch, run) for name, run in runs.items()}

    result["ms"] = times()
    own = _build.load_library("viterbi")
    result["sass"] = sass_counts(_build._target("viterbi")[1])
    try:
        for name, subs in VARIANTS.items():
            _build._libs["viterbi"] = build(name, subs)
            result[f"ms_{name}"] = times()
        _build._libs["viterbi"] = build("clocks", CLOCKS)
        result["cycles_per_frame"] = {}
        for name, run in runs.items():
            _, final = run()
            warps = result["cases"][name]["warps"]
            frames = cases[name][2].cpu().numpy().astype(np.float64)[:, None, None]
            c = final.cpu().numpy()[:, :3 * warps].reshape(-1, warps, 3) / frames
            result["cycles_per_frame"][name] = {
                "pass_by_warp": c[..., 0].mean(0).round().tolist(),
                "after_pass": float(c[..., 1].mean()), "barrier": float(c[..., 2].mean())}
    finally:
        _build._libs["viterbi"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_viterbi": result}, default=lambda x: float(np.asarray(x)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
