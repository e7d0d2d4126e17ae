"""Time the CTC pair (``ctc_alpha``, ``ctc_grad``), the dense backtrace and
the whole-scan Viterbi decode of this checkout against another's.

    python -m gtn_applications_tpu_torch.scripts.compare_ctc_viterbi \
        --baseline DIR [--out FILE]

DIR is the root of another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into an ignored directory):
its ``gtn_applications_tpu_torch`` package is loaded under another name
(``compare_sparse_scan.load_baseline``) and builds its kernels into
DIR/build.  Both versions run on the same inputs, in turns baseline,
this, this, baseline, each a CUDA-event median of 30 runs
(``chip_smoke.gpu_median_ms``):

- ``ctc_alpha`` at the three shapes below: the max |d| between the two
  alphas (the same bit for bit where both keep lse3's operand order; more
  than 1e-3 fails), this checkout's route (``lattice_pallas.alpha_plan``),
  the chain bound and the kernels one call of each side launches;
- ``dense_backtrace`` at the ASG headline (``chip_smoke.asg_headline_inputs``:
  B=32, T=250, C=80) and ``chip_smoke.DENSE_BT_MORE`` (B=8, T=1000, C=80
  and B=8, T=250, C=81): the paths must be equal; beside them this
  checkout's chunk plan (``viterbi_scan_pallas.dense_bt_plan``), the walk's
  chain bound (T - 1 frames of ``backtrace_chain_probe``) and the kernels
  a call;
- ``ctc_grad`` at the three shapes ``chip_smoke.py`` times (the CTC
  headline, B=32, T=250, L=44, S=89, and ``chip_smoke.CTC_WIDE``: S=241 at
  B=8, T=300 and S=401 at B=8, T=500); the two gradients must agree within
  1e-5 (each side is held to the plain version by ``chip_smoke.py``);
  beside them this checkout's route (``lattice_pallas.grad_plan``), the
  chain bound (the longest sample's frames less one x one frame of
  ``ctc_chain_probe``) and the kernels one call of each side launches
  (torch.profiler);
- the decode at the headline (``chip_smoke.viterbi_headline_inputs``:
  B=32, T=250, C=80, S=82, 6,480 arcs) and on the backoff trigram path's
  decode table (its criterion's loaded weights, S=95, 1,932 arcs; random
  N(0, 1) emissions, full lengths, B=32) at T=300 and T=608 (its longest
  lines, where the walk words go to the global scratch): each side's
  decode (one launch, scan and walk; a baseline from before the walk was
  fused, with ``viterbi_backtrace_cuda``, is not taken) and its scan
  alone, the walk's share their difference; each side's
  ``viterbi_scan`` (wrapper included) on the host clock; labels and slots
  must be equal and scores within 1e-6.  Beside them this checkout's route,
  walk and emission rows, the walk's chain bound (the longest sample's
  frames x one frame of ``backtrace_chain_probe``) and the kernels one
  decode of each side launches (torch.profiler).

One JSON line (also written to FILE) with the card's name and power
limit.  Run from the root of this checkout on a machine with one GPU.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def turns(torch, cs, runs):
    """{side: [ms, ms]} of ``runs`` timed baseline, this, this, baseline."""
    out = {}
    for who in ("base", "new", "new", "base"):
        out.setdefault(who, []).append(cs.gpu_median_ms(torch, runs[who]))
    return out


def walk_frame_us(torch, cs, dev):
    """One frame of the walks' chain (``backtrace_chain_probe``), in us."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    n = 4096
    t_n = cs.gpu_median_ms(torch, lambda: vsp.walk_probe(cs.B, n, dev), runs=20)
    t_2n = cs.gpu_median_ms(torch, lambda: vsp.walk_probe(cs.B, 2 * n, dev), runs=20)
    return (t_2n - t_n) / n * 1e3


def alpha_ab(torch, cs, root, dev):
    """The CTC forward at its three shapes (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp
    from gtn_applications_tpu_torch.scripts.compare_sparse_scan import load_baseline

    base = load_baseline(root, "ops.lattice_pallas")
    frame_us = cs.ctc_chain_frame_us(torch, dev)
    out = {"chain_frame_us": frame_us}
    for i, (b, t, l) in enumerate(((cs.B, cs.T, cs.L),) + cs.CTC_WIDE):
        em, start, _, skip, il, _ = cs.ctc_case(torch, dev, b, t, l, seed=i + 1 if i else 0)
        args = (em, start, skip, il)
        runs = {"base": lambda: base.ctc_alpha_cuda(*args), "new": lambda: lp.ctc_alpha_cuda(*args)}
        d = float((runs["base"]() - runs["new"]()).abs().max())
        if not d <= 1e-3:
            raise AssertionError(f"ctc_alpha S={em.shape[2]}: the two alphas differ by {d}")
        S = em.shape[2]
        row = {"shape": [b, t, S], "max_len": int(il.max()), "route": lp.alpha_plan(S),
               "max_abs_alpha_diff": d,
               "chain_bound_ms": (int(il.max()) - 1) * frame_us * 1e-3,
               "kernels_a_call": {who: cs.kernel_launches(torch, run, "ctc_alpha")
                                  for who, run in runs.items()},
               **{f"{who}_ms": ms for who, ms in turns(torch, cs, runs).items()}}
        out[f"S{S}"] = row
        print(json.dumps({f"ctc_alpha_S{S}": row}), flush=True)
    return out


def dense_bt_ab(torch, cs, root, dev, walk_us):
    """The dense backtrace at its three shapes (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.scripts.compare_sparse_scan import load_baseline

    base = load_baseline(root, "ops.viterbi_scan_pallas")
    out = {"walk_frame_us": walk_us}
    for shape in ((cs.B, cs.T, cs.ASG_C),) + cs.DENSE_BT_MORE:
        bp, last = cs.asg_headline_inputs(torch, dev, *shape)
        runs = {"base": lambda: base.dense_backtrace_cuda(bp, last),
                "new": lambda: vsp.dense_backtrace_cuda(bp, last)}
        if not torch.equal(runs["base"](), runs["new"]()):
            raise AssertionError(f"dense_backtrace {shape}: the two paths differ")
        row = {"shape": list(shape), "plan": vsp.dense_bt_plan(shape[1], shape[2]),
               "chain_bound_ms": (shape[1] - 1) * walk_us * 1e-3,
               "kernels_a_call": {who: cs.kernel_launches(torch, run, "dense_backtrace")
                                  for who, run in runs.items()},
               **{f"{who}_ms": ms for who, ms in turns(torch, cs, runs).items()}}
        key = "x".join(map(str, shape))
        out[key] = row
        print(json.dumps({f"dense_bt_{key}": row}), flush=True)
    return out


def ctc_ab(torch, cs, root, dev):
    """The CTC backward at its three shapes (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp
    from gtn_applications_tpu_torch.scripts.compare_sparse_scan import load_baseline

    base = load_baseline(root, "ops.lattice_pallas")
    frame_us = cs.ctc_chain_frame_us(torch, dev)
    out = {"chain_frame_us": frame_us}
    for i, (b, t, l) in enumerate(((cs.B, cs.T, cs.L),) + cs.CTC_WIDE):
        em, start, accept, skip, il, g = cs.ctc_case(torch, dev, b, t, l, seed=i + 1 if i else 0)
        alpha = lp.ctc_alpha_cuda(em, start, skip, il)
        args = (em, alpha, accept, skip, il, lp._final_score(alpha[:, -1], accept), g)
        runs = {"base": lambda: base.ctc_grad_cuda(*args), "new": lambda: lp.ctc_grad_cuda(*args)}
        d = float((runs["base"]() - runs["new"]()).abs().max())
        if not d <= 1e-5:
            raise AssertionError(f"ctc_grad S={em.shape[2]}: the two gradients differ by {d}")
        S = em.shape[2]
        row = {"shape": [b, t, S], "max_len": int(il.max()), "route": lp.grad_plan(S),
               "max_abs_grad_diff": d,
               "chain_bound_ms": (int(il.max()) - 1) * frame_us * 1e-3,
               "kernels_a_call": {who: cs.kernel_launches(torch, run, "ctc_grad")
                                  for who, run in runs.items()},
               **{f"{who}_ms": ms for who, ms in turns(torch, cs, runs).items()}}
        out[f"S{S}"] = row
        print(json.dumps({f"ctc_grad_S{S}": row}), flush=True)
    return out


def decode_cases(torch, cs, dev):
    """(name, em, lens, table) of the decode's cases."""
    import numpy as np

    from gtn_applications_tpu_torch.scripts.compare_sparse_scan import trigram_decode_inputs

    head = cs.viterbi_headline_inputs(torch, dev, with_table=True)
    crit, _, _ = trigram_decode_inputs(torch, cs, dev)
    table = crit._decode_table(crit.params)
    rng = np.random.RandomState(21)
    out = [("headline", head[0], head[6], head[7])]
    for t in (300, 608):
        em = torch.from_numpy(rng.randn(cs.B, t, crit.num_channels).astype(np.float32)).to(dev)
        out.append((f"trigram_T{t}", em, torch.full((cs.B,), t, dtype=torch.int32, device=dev),
                    table))
    return out


def decode_ab(torch, cs, root, dev, walk_us):
    """The decode (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.scripts.compare_sparse_scan import (
        host_median_ms, load_baseline)

    base = load_baseline(root, "ops.viterbi_scan_pallas")
    out = {"walk_frame_us": walk_us}
    for name, em, lens, table in decode_cases(torch, cs, dev):
        B, T, C = em.shape
        plan, plan_b = vsp.build_plan(table), base.build_plan(table)
        src_b, lab_b, w_b, start, accept = plan.to(dev)
        bsrc, blab, bw, bstart, bacc = plan_b.to(dev)
        packed, packed_b = plan.packed(dev), plan_b.packed(dev)
        S = start.shape[0]

        def base_decode():
            slots, _, labels, score = base.viterbi_scan_fwd_cuda(
                em, bsrc, blab, bw, bstart, lens, packed=packed_b, accept=bacc)
            return slots, (labels, score)

        def new_decode():
            slots, _, labels, score = vsp.viterbi_scan_fwd_cuda(
                em, src_b, lab_b, w_b, start, lens, packed=packed, accept=accept)
            return slots, (labels, score)

        (slots_b, (lab_b_, score_b)), (slots_n, (lab_n, score_n)) = base_decode(), new_decode()
        if not (torch.equal(slots_b, slots_n) and torch.equal(lab_b_, lab_n)):
            raise AssertionError(f"{name}: the two decodes' slots or labels differ")
        d_score = float((score_b - score_n).abs().max())
        if not d_score <= 1e-6:
            raise AssertionError(f"{name}: the two decodes' scores differ by {d_score}")
        route = vsp.scan_route(packed, S, C, "chunked", T)
        walk = vsp.walk_route(packed, S, T, C, route)
        scan = {"base": lambda: base.viterbi_scan_fwd_cuda(em, bsrc, blab, bw, bstart, lens,
                                                           packed=packed_b),
                "new": lambda: vsp.viterbi_scan_fwd_cuda(em, src_b, lab_b, w_b, start, lens,
                                                         packed=packed)}
        wrapper = {"base": lambda: base.viterbi_scan(em, plan_b, lens),
                   "new": lambda: vsp.viterbi_scan(em, plan, lens)}
        row = {"shape": [B, T, C], "S": S, "A": packed.A, "max_len": int(lens.max()),
               "route": route, "walk": walk, "rows": vsp.scan_rows(packed, S, T, C, route, walk),
               "max_abs_score_diff": d_score,
               "walk_chain_bound_ms": int(lens.max()) * walk_us * 1e-3,
               "kernels_a_decode": {who: cs.kernel_launches(torch, run, "viterbi")
                                    for who, run in wrapper.items()}}
        for key, ms in turns(torch, cs, {"base": base_decode, "new": new_decode}).items():
            row[f"{key}_decode_ms"] = ms
        for key, ms in turns(torch, cs, scan).items():
            row[f"{key}_scan_ms"] = ms
        for who in ("base", "new", "new", "base"):
            row.setdefault(f"{who}_wrapper_host_ms", []).append(
                host_median_ms(torch, wrapper[who]))
        for who in ("base", "new"):
            row[f"{who}_walk_share_ms"] = (statistics.mean(row[f"{who}_decode_ms"])
                                           - statistics.mean(row[f"{who}_scan_ms"]))
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, help="root of the other checkout")
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from gtn_applications_tpu_torch import utils

    if not torch.cuda.is_available():
        raise SystemExit("compare_ctc_viterbi needs a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    walk_us = walk_frame_us(torch, cs, dev)
    result = {"card": utils.card_name_and_power_limit(),
              "ctc_alpha": alpha_ab(torch, cs, args.baseline, dev),
              "dense_bt": dense_bt_ab(torch, cs, args.baseline, dev, walk_us),
              "ctc_grad": ctc_ab(torch, cs, args.baseline, dev),
              "decode": decode_ab(torch, cs, args.baseline, dev, walk_us)}
    line = json.dumps({"compare_ctc_viterbi": result})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
