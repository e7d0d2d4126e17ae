"""Where the seg_lse pair's time goes (``seg_lse_fwd`` and ``seg_lse_bwd``,
csrc/sparse_scan.cu).

    python -m gtn_applications_tpu_torch.scripts.profile_seglse [--out FILE]

The card's profilers (ncu, nsys) do not run on every machine, so this
script measures the kernels by parts itself, on the first round of the
start closure of three tables (``chip_smoke.sparse_times``' cases: the
1kwp normaliser, the headline, B=32, S=1,004 with a hub of in-degree
1,002 and a row of 181; the 4-gram path's normaliser, S=1,058 with a hub
of 287; the trigram path's composed table, per sample, S=216):

- the pair (CUDA-event medians of 30, ``chip_smoke.gpu_median_ms``; the
  forward with its statistics, as the loss runs it), and one PyTorch
  ``fill_`` of one element, the cost of a launch and its events alone;
- copies of ``csrc/sparse_scan.cu`` with one part changed, built into
  ``build/profile_seglse`` and timed the same way: every row empty
  (``no_rows``: the launch, the row pointers' loads and the stores), no
  hubs (``no_hubs``), no ``expf`` (``no_exp``), and the arcs' second
  round of loads gone (``no_gather``: alpha, w and em, or w, em, m, z and
  g, not read).  Their results are wrong; only their times mean
  something;
- a copy that counts ``clock64`` cycles in each warp of a block from its
  start: to its row pointers' arrival, to the end of the hub barrier, to
  its end; for the block that holds the table's largest row and for one
  without rows, averaged over the samples.

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
OUT_DIR = ROOT / "build" / "profile_seglse"

ROW_WIDTH = "  const int wd = row_width(end - beg);\n"
FWD_GATHER = ("    a[j] = ld<kStaged>(al, max(u[j], 0));\n"
              "    wv[j] = ld<kStaged>(arcs.w, id[j]);\n"
              "    ev[j] = kEm ? ld<kStaged>(arcs.em, id[j]) : 0.0f;\n")
BWD_GATHER = ("      wv[j] = __ldg(w + i);\n"
              "      ev[j] = kEm ? __ldg(em + i) : 0.0f;\n"
              "      mv[j] = __ldg(m + q);\n"
              "      zv[j] = __ldg(z + q);\n"
              "      gv[j] = __ldg(g + q);\n")
# every substitution: (old, new, how many times old must appear)
VARIANTS = {
    "no_rows": [(ROW_WIDTH, "  const int wd = 0 * row_width(end - beg);\n", 2)],
    "no_hubs": [("  if (!__syncthreads_or(w < 0)) return false;\n",
                 "  if (__syncthreads_or(w < 0) >= 0) return false;\n", 1)],
    "no_exp": [("if (c[j] > kDead) z += expf(c[j] - m);", "if (c[j] > kDead) z += c[j] - m;", 2),
               ("if (more[j] > kDead) z += expf(more[j] - m);",
                "if (more[j] > kDead) z += more[j] - m;", 1),
               ("? expf(c - mv[j]) / zv[j] * gv[j] : 0.0f;",
                "? (c - mv[j]) / zv[j] * gv[j] : 0.0f;", 1)],
    "no_gather": [(FWD_GATHER, "    a[j] = float(u[j]);\n    wv[j] = float(id[j]);\n"
                   "    ev[j] = 0.0f;\n", 1),
                  (BWD_GATHER, "      wv[j] = float(i);\n      ev[j] = 0.0f;\n"
                   "      mv[j] = float(q);\n      zv[j] = 1.0f;\n      gv[j] = 1.0f;\n", 1)],
}
# per warp, cycles from the block's start to the row pointers' arrival, to
# the end of the hub barrier and to the warp's end, written after a last
# barrier into the rows r0 + 32 w .. + 2 of m_out (forward) or dalpha
# (backward)
CLOCK_START = ("  const int r = r0 + threadIdx.x;\n"
               "  const int beg = r < S ? P[r] : 0, end = r < S ? P[r + 1] : 0;\n")
HUBS = "  const bool hubs = hubs_pending(wd, hub_row, hub_n, busy, hw);\n"
CLOCKS = [
    (CLOCK_START, "  const long long k0 = clock64();\n" + CLOCK_START, 2),
    (ROW_WIDTH, ROW_WIDTH + "  volatile int sink = wd;  // waits for the pointers\n"
     "  const long long k1 = clock64();\n  (void)sink;\n", 2),
    (HUBS, HUBS + "  const long long k2 = clock64();\n", 2),
    ("          emit(h, m, z);\n        }\n      }\n    }\n  }\n}",
     "          emit(h, m, z);\n        }\n      }\n    }\n  }\n"
     "  const long long k3 = clock64();\n  __syncthreads();\n"
     "  if (lane == 0 && m_out && r0 + 32 * warp + 2 < S) {\n"
     "    float* o = m_out + static_cast<long>(b) * S + r0 + 32 * warp;\n"
     "    o[0] = k1 - k0;\n    o[1] = k2 - k0;\n    o[2] = k3 - k0;\n  }\n}", 1),
    ("          dalpha[row + h] = s;\n        }\n      }\n    }\n  }\n}",
     "          dalpha[row + h] = s;\n        }\n      }\n    }\n  }\n"
     "  const long long k3 = clock64();\n  __syncthreads();\n"
     "  if (lane == 0 && r0 + 32 * warp + 2 < S) {\n"
     "    float* o = dalpha + row + r0 + 32 * warp;\n"
     "    o[0] = k1 - k0;\n    o[1] = k2 - k0;\n    o[2] = k3 - k0;\n  }\n}", 1),
]


def build(name, subs):
    """A copy of the kernels' source with ``subs`` applied, compiled as the
    port compiles its own; returns the bound library."""
    from gtn_applications_tpu_torch.ops import _build

    src = SOURCE.read_text()
    for old, new, count in subs:
        if src.count(old) != count:
            raise RuntimeError(f"profile_seglse: the {name} copy no longer matches the source")
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
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp

    if not torch.cuda.is_available():
        raise SystemExit("profile_seglse needs a GPU")
    dev = torch.device("cuda")
    _, _, _, tables = cs.backoff_lm_inputs(torch, dev)
    _, _, _, tables3 = cs.backoff_main_inputs(torch, dev)
    _, _, _, tables4 = cs.backoff_main_inputs(torch, dev, path="transducer_backoff_4gram")
    cases, runs, shapes = {}, {}, {}
    for name, table in (("1kwp_norm", tables["norm"]), ("4gram_norm", tables4["norm"]),
                        ("trigram_score", tables3["score"])):
        (_, _, _, _, esrc, edst, ew), start, _, _ = cs.sparse_fields(table)
        B, S = cs.LM_B, start.shape[-1]
        alpha = start.expand(B, S).contiguous()
        idx = slp.arc_index(esrc, edst, S)
        g = torch.rand(B, S, device=dev)
        _, m, z = slp.seg_lse_fwd_cuda(alpha, ew, None, idx, stats=True)
        cases[name] = (alpha, ew, idx, m, z, g)
        runs[name + "_fwd"] = (lambda a=(alpha, ew, None, idx):
                               slp.seg_lse_fwd_cuda(*a, stats=True))
        runs[name + "_bwd"] = (lambda a=(alpha, ew, None, idx, m, z, g):
                               slp.seg_lse_bwd_cuda(*a))
        degree = torch.diff(idx.dptr[0].long())
        shapes[name] = {"B": B, "S": S, "E": int(esrc.shape[-1]),
                        "largest_row": int(degree.argmax()),
                        "in_degree_max": int(degree.max()),
                        "out_degree_max": int(torch.diff(idx.sptr.long(), dim=1).max()),
                        "fwd_staged": slp.stage_words(S, esrc.shape[-1], None)
                        <= slp.STAGE_WORDS}

    def times():
        return {name: cs.gpu_median_ms(torch, run) for name, run in runs.items()}

    one = torch.zeros(1, device=dev)
    result = {"card": utils.card_name_and_power_limit(), "shapes": shapes, "ms": times(),
              "fill_one_ms": cs.gpu_median_ms(torch, lambda: one.fill_(1.0))}
    print(result, flush=True)
    own = _build.load_library("sparse_scan")
    try:
        for name, subs in VARIANTS.items():
            _build._libs["sparse_scan"] = build(name, subs)
            result[f"ms_{name}"] = times()
            print(name, result[f"ms_{name}"], flush=True)
        _build._libs["sparse_scan"] = build("clocks", CLOCKS)
        result["cycles"] = {}
        for name, (alpha, ew, idx, m, z, g) in cases.items():
            S = alpha.shape[1]
            hub_block = shapes[name]["largest_row"] // 256
            blocks = {"largest_row_block": hub_block}
            if S > 256:
                blocks["block_without_rows"] = next(
                    (k for k in range(-(-S // 256)) if k != hub_block
                     and not bool((torch.diff(idx.dptr.long(), dim=1)[:, 256 * k:256 * (k + 1)]
                                   > 0).any())), None)
            _, m_c, _ = slp.seg_lse_fwd_cuda(alpha, ew, None, idx, stats=True)
            da_c, _ = slp.seg_lse_bwd_cuda(alpha, ew, None, idx, m, z, g)
            out = {}
            for what, k in blocks.items():
                if k is None:
                    continue
                for kern, x in (("fwd", m_c), ("bwd", da_c)):
                    rows = x[:, 256 * k:256 * (k + 1)].cpu().numpy().astype(np.float64)
                    w = rows.shape[1] // 32
                    per = rows[:, :32 * w].reshape(-1, w, 32)[..., :3].mean(0)
                    out[f"{kern}_{what}_{k}"] = {
                        "pointers_hub_barrier_end_by_warp": per.round().tolist()}
            result["cycles"][name] = out
        print(result["cycles"], flush=True)
    finally:
        _build._libs["sparse_scan"] = own
    try:  # the SM clock the cycles were counted at (read through NVML)
        result["sm_clock_mhz"] = torch.cuda.clock_rate(dev)
    except (ModuleNotFoundError, RuntimeError):
        result["sm_clock_mhz"] = None
    line = json.dumps({"profile_seglse": result}, default=lambda x: float(np.asarray(x)))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
