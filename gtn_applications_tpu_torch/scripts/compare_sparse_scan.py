"""Time the whole sparse scan pair (or, with ``--decode``, the Viterbi
decode of the 4-gram path; with ``--viterbi``, the whole-scan Viterbi;
with ``--factored``, the factored scan pair; with ``--seglse``, the
seg_lse pair; with ``--dense``, the dense scan pair) of this checkout
against another's.

    python -m gtn_applications_tpu_torch.scripts.compare_sparse_scan \
        --baseline DIR [--clusters 1 2 4 8] [--phases] [--decode] \
        [--viterbi [--caps 4 8 16]] [--factored] [--seglse] [--dense] \
        [--out FILE]

DIR is the root of another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into an ignored directory):
its ``gtn_applications_tpu_torch`` package is loaded under another name
and builds its kernels into DIR/build.  Both versions run on the same
inputs at the six cases ``chip_smoke.sparse_times`` times (the 1kwp
protocol's normaliser and composed tables, B=32, T=100; the backoff
paths' trigram and 4-gram normalisers and composed tables, B=32, T=300),
in turns: baseline, this, this, baseline, each a CUDA-event median of 30
runs (``chip_smoke.gpu_median_ms``).  One JSON line (also written to
FILE) gives the times in ms, the card's name and power limit and, per
case, the largest difference between the two trajectories on live
states.  ``--accuracy SCALE ...`` also gives each forward's distance from the
scan in float64 (the plain version on the same inputs): the largest
|d| on the trajectory's live states within 80 nats of each frame's
largest, as ``chip_smoke.hold_sparse_kernels`` holds it, with the
emissions scaled by each SCALE, beside the float32 plain version's;
``--frames`` sets the cases' T (default 300).
``--clusters`` also times this checkout's pair at each of those
cluster sizes, with how many of its clusters the card holds at once.
``--phases`` also times it at each closure depth from 0 to the table's
(its batch's cluster size throughout): the time at depth 0 is the arc
step's and the frame shift's, and each further depth adds one closure
round (forward) or its replay and reverse (backward).
``--decode`` times ``ops.sparse.viterbi_batch`` instead, on the unpruned
grapheme 4-gram's decode table (S=1,058, A=35,455, C=12, which the bucket
plan refuses) at two shapes: ``chip_smoke.segmax_scan_inputs`` (B=32,
T=300, ragged lengths, one infeasible sample) and the 4-gram path's first
train batch (B=32, its frames, random N(0, 1) emissions, full lengths).
Per case, in turns baseline, this, this, baseline: the host-clock median
of 5 decodes after one warm-up, ending in ``torch.cuda.synchronize()``,
and the CUDA-event median of the decode's kernel: ``seg_max_scan`` (one
launch a batch, where the checkout has it) or one ``seg_max`` step (the
parent's per-frame kernel; its decode launches it once a frame).  The
two decodes' labels must be equal and their scores within 1e-6.
``--viterbi`` times ``viterbi_scan_fwd`` (the whole-scan Viterbi's
forward kernel) instead, at two tables: the decode headline
(``chip_smoke.viterbi_headline_inputs``: B=32, T=250, C=80, S=82, 6,480
arcs) and the backoff trigram path's decode table (its criterion's loaded
weights; B=32, the path's first train batch's frames, random N(0, 1)
emissions, full lengths), baseline, this, this, baseline (slots must be
equal and final alphas within 1e-6); beside them this checkout's kernel
by each route that fits and at each per-lane cap of ``--caps``, the
bound (``chip_smoke.viterbi_scan_bound``), the chain bound (the longest
sample's frames x ``viterbi_chain_probe``'s frame at the launch's block
size) and ``seg_max_scan`` on the same table and inputs as a yardstick.
Then the host-clock median of 5 decodes (``ops.sparse.viterbi_batch``,
scan and backtrace) of the trigram path's batch, baseline, this, this,
baseline: on one table (its plan cached), and on a table re-weighted
before every decode, as each train step's decode meets it (plan and
packing built anew).
``--factored`` times the factored scan pair (``factored_scan_fwd`` and
``factored_scan_bwd``, the bigram Transducer's criterion kernels) instead,
on the lattices of ``chip_smoke.NGRAM_CASES`` (B=32, T=250: the ngram-2
headline, S=96; the IAM width, S=136; the forced blank, S=136):
baseline, this, this, baseline for the forward, the backward without
dadj (the main path's) and with it (both backwards on the baseline's
trajectory); this forward's live states must be live in the baseline's,
and the states live only there (a baseline without the FLT_MIN gate) and
the trajectories' largest difference on this one's live states are
logged.
Beside them: this checkout's routes (``chip_smoke.factored_routes``), its
bound (``chip_smoke.factored_work``) and the count of PRs 3-8, the chain
bound (the longest sample's frames x ``factored_chain_probe``'s frame) and
the kernels one call of each launches (torch.profiler), for both.
``--seglse`` times the seg_lse pair instead, on the first round of the
start closure of each of the six cases' tables that has epsilon arcs, as
each checkout's loss runs it (the baseline's wrapper gathers w and a zero
em into the index's order, this one's reads w through the index and has
no em): baseline, this, this, baseline, the forward kernel (here with
the statistics the backward reads), the backward kernel, and the whole
step (``seg_lse``, wrapper included; epsilon weights and alpha needing
gradients) forward and forward and backward; the two forwards' live sets
must be equal and their values within atol 1e-3 + rtol 1e-5, and their
cotangents' largest difference is logged.  Beside them: this checkout's
forward by each route (alpha, w and em staged in shared memory or
gathered from device memory; ``new_fwd_staged``: the wrapper's choice)
and without its statistics, its backward without dcontrib, the kernels each side's step launches
(torch.profiler), and the table's largest in- and out-degree.
``--dense`` times the dense scan pair (``dense_scan_fwd`` and
``dense_scan_bwd``, the kernels of STC's dense tier and of the
transitions-free Transducer) instead, at ``chip_smoke.dense_time_cases``
(the STC headline, B=32, T=250, S=96; S=304, B=8, T=128; the word
decompositions at the 1k inventory, B=32, T=100, S=376): baseline, this,
this, baseline for the forward, the backward without dadj (the main
paths') and with it; the forwards' live sets and trajectories as for
``--factored``, and the two backwards' dem and dadj (on the baseline's
trajectory) are compared entry by entry
(``chip_smoke.entrywise_err``, logged: each side is held to the plain
versions by ``chip_smoke.py``).  Beside them: this checkout's routes
(``chip_smoke.dense_routes``), its bounds by real arcs
(``chip_smoke.dense_bounds``) beside the O(S^2) count of PRs 2-10, the
chain bounds (``chip_smoke.dense_chain_bounds``) and the kernels one
call of each launches (torch.profiler), for both.
Run from the root of this checkout on a machine with one GPU.
"""

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_baseline(root, name="ops.sparse_scan_pallas"):
    """The baseline checkout's module ``name`` of its port, as a module of
    the package ``baseline_port``."""
    if "baseline_port" not in sys.modules:
        pkg = Path(root).resolve() / "gtn_applications_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "baseline_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules["baseline_port"] = module
        spec.loader.exec_module(module)
    return importlib.import_module("baseline_port." + name)


def cases(torch, cs, dev, t=300):
    """(name, em, lens, table) of the six cases; the backoff paths' at
    ``t`` frames."""
    _, em, lens, tables = cs.backoff_lm_inputs(torch, dev)
    _, em3, lens3, tables3 = cs.backoff_main_inputs(torch, dev, t=t)
    _, em4, lens4, tables4 = cs.backoff_main_inputs(torch, dev, t=t,
                                                    path="transducer_backoff_4gram")
    return [("1kwp_norm", em, lens, tables["norm"]), ("1kwp_score", em, lens, tables["score"]),
            ("trigram_norm", em3, lens3, tables3["norm"]),
            ("trigram_score", em3, lens3, tables3["score"]),
            ("4gram_norm", em4, lens4, tables4["norm"]),
            ("4gram_score", em4, lens4, tables4["score"])]


def host_median_ms(torch, fn, runs=5):
    """Host-clock median of ``fn`` ending in a synchronise, after one
    warm-up."""
    import statistics
    import time

    ms = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def decode_ab(torch, cs, root, dev):
    """The ``--decode`` comparison (see the module docstring)."""
    import numpy as np

    from gtn_applications_tpu_torch import datasets, utils
    from gtn_applications_tpu_torch.ops import _build, sparse
    from gtn_applications_tpu_torch.ops import segmax_pallas as smp
    from gtn_applications_tpu_torch.ops.seglse_pallas import arc_index, take

    base_sparse = load_baseline(root, "ops.sparse")
    base_smp = load_baseline(root, "ops.segmax_pallas")
    config = cs.main_path_config("transducer_backoff_4gram")
    # the trainer's first batch, as chip_smoke.first_batch reads it
    data = getattr(datasets, config["data"]["dataset"])
    pre = data.Preprocessor(None, num_features=config["data"]["num_features"])
    loader = utils.data_loader(data.Dataset(None, pre, split="train", augment=True), config,
                               seed=config["seed"])
    inputs = next(iter(loader))[0]
    stride = int(np.prod([g["stride"][1] for g in config["model"]["tds_groups"]]))
    em, lens, table = cs.segmax_scan_inputs(torch, dev)
    B, C = em.shape[0], em.shape[2]
    frames = -(-inputs.shape[-1] // stride)
    rng = np.random.RandomState(17)
    em_main = torch.from_numpy(rng.randn(B, frames, C).astype(np.float32)).to(dev)
    lens_main = torch.full((B,), frames, dtype=torch.int32, device=dev)
    out = {}
    for name, e, il in (("4gram_T300", em, lens), (f"4gram_main_T{frames}", em_main, lens_main)):
        plans = {}
        decode = {"base": lambda e=e, il=il: base_sparse.viterbi_batch(e, table, il),
                  "new": lambda e=e, il=il: sparse.viterbi_batch(e, table, il, plans)}
        (lab_b, score_b), (lab_n, score_n) = decode["base"](), decode["new"]()
        if not torch.equal(lab_b, lab_n):
            raise AssertionError(f"{name}: the decodes' labels differ")
        d_score = float((score_b - score_n).abs().max())
        if not d_score <= 1e-6:
            raise AssertionError(f"{name}: the decodes' scores differ by {d_score}")
        # each side's kernel: one seg_max step of the parent (at the
        # batch's first frame from the start potentials), seg_max_scan here
        tab = table.to(dev)
        src, dst, w, label = (x[None] for x in (tab.src, tab.dst, tab.weight, tab.label))
        alpha = tab.start.expand(B, -1).contiguous()
        idx = arc_index(src, dst, alpha.shape[1], label, C)
        w_s = take(w, idx.order)
        row = e[:, 0]
        plan = plans[(e.device, C)]
        scan_args = (e, take(w, plan.main.order), tab.start.contiguous(),
                     tab.accept.contiguous(), il, plan)
        kernel = {"base": lambda: base_smp.seg_max_cuda(alpha, w_s, row, idx),
                  "new": lambda: smp.seg_max_scan_cuda(*scan_args)}
        row_out = {"shape": list(e.shape), "max_len": int(il.max()),
                   "max_abs_score_diff": d_score,
                   "kernel": {"base": "seg_max (one frame)", "new": "seg_max_scan"}}
        before = dict(_build.LAUNCHES)
        decode["new"]()
        row_out["new_launches_per_decode"] = {
            key: n - before[key] for key, n in _build.LAUNCHES.items() if n != before[key]}
        for who in ("base", "new", "new", "base"):
            row_out.setdefault(f"{who}_host_ms", []).append(host_median_ms(torch, decode[who]))
            row_out.setdefault(f"{who}_kernel_ms", []).append(
                cs.gpu_median_ms(torch, kernel[who]))
        out[name] = row_out
        print(json.dumps({name: row_out}), flush=True)
    return out


def trigram_decode_inputs(torch, cs, dev, B=32, seed=18):
    """(criterion, em, lens) of the backoff trigram path's decode: its
    criterion with the loaded LM's weights, random N(0, 1) emissions over
    its first train batch's frames, full lengths."""
    import numpy as np

    from gtn_applications_tpu_torch import datasets, utils

    config = cs.main_path_config("transducer_backoff")
    data = getattr(datasets, config["data"]["dataset"])
    pre = data.Preprocessor(None, num_features=config["data"]["num_features"])
    loader = utils.data_loader(data.Dataset(None, pre, split="train", augment=True), config,
                               seed=config["seed"])
    inputs = next(iter(loader))[0]
    stride = int(np.prod([g["stride"][1] for g in config["model"]["tds_groups"]]))
    frames = -(-inputs.shape[-1] // stride)
    crit, _ = utils.load_criterion(config["criterion_type"], pre, config["criterion"])
    rng = np.random.RandomState(seed)
    em = torch.from_numpy(rng.randn(B, frames, crit.num_channels).astype(np.float32)).to(dev)
    return crit, em, torch.full((B,), frames, dtype=torch.int32, device=dev)


def viterbi_ab(torch, cs, root, dev, caps):
    """The ``--viterbi`` comparison (see the module docstring)."""
    import numpy as np

    from gtn_applications_tpu_torch.ops import sparse
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
    from gtn_applications_tpu_torch.wfst import compile as wcompile

    base_vsp = load_baseline(root, "ops.viterbi_scan_pallas")
    base_sparse = load_baseline(root, "ops.sparse")
    head = cs.viterbi_headline_inputs(torch, dev, with_table=True)
    crit, em3, lens3 = trigram_decode_inputs(torch, cs, dev)
    table3 = crit._decode_table(crit.params)
    out = {}
    for name, em, lens, table in (("headline", head[0], head[6], head[7]),
                                  ("trigram", em3, lens3, table3)):
        B, T, C = em.shape
        plan, plan_b = vsp.build_plan(table), base_vsp.build_plan(table)
        src_b, lab_b, w_b, start, _ = plan.to(dev)
        base_args = (em,) + plan_b.to(dev)[:4] + (lens,)
        packed = plan.packed(dev)
        run = {"base": lambda a=base_args: base_vsp.viterbi_scan_fwd_cuda(*a),
               "new": lambda: vsp.viterbi_scan_fwd_cuda(em, src_b, lab_b, w_b, start, lens,
                                                        packed=packed)}
        (slots_b, final_b), (slots_n, final_n) = run["base"](), run["new"]()
        if not torch.equal(slots_b, slots_n):
            raise AssertionError(f"{name}: the two kernels' slots differ")
        d_final = float((final_b - final_n).abs().max())
        if not d_final <= 1e-6:
            raise AssertionError(f"{name}: the two kernels' final alphas differ by {d_final}")
        S = start.shape[0]
        route = vsp.scan_route(packed, S, C)
        threads = vsp.WARP * min(packed.slots, vsp.MAX_WARPS)
        frame_us = cs.viterbi_chain_frame_us(torch, B, threads, dev)
        b_ms, b_by = cs.viterbi_scan_bound(em, lens, w_b)
        row = {"shape": list(em.shape), "S": S, "D": plan.D, "A": packed.A,
               "DS": plan.D * S, "max_len": int(lens.max()), "route": route,
               "cap": packed.cap, "slots": packed.slots, "threads": threads,
               "max_abs_final_diff": d_final, "bound_ms": b_ms, "bound_by": b_by,
               "chain_frame_us": frame_us, "chain_bound_ms": int(lens.max()) * frame_us * 1e-3,
               "seg_max_scan_ms": cs.viterbi_yardstick_ms(torch, em, lens, table)}
        for who in ("base", "new", "new", "base"):
            row.setdefault(f"{who}_ms", []).append(cs.gpu_median_ms(torch, run[who]))
        row["new_by_route_ms"] = {
            r: cs.gpu_median_ms(torch, lambda r=r: vsp.viterbi_scan_fwd_cuda(
                em, src_b, lab_b, w_b, start, lens, packed=packed, route=r))
            for r in vsp.ROUTES if vsp.route_fits(packed, S, C, r)}
        row["new_by_cap"] = {}
        for cap in caps:
            pc = plan.packed(dev, cap)
            row["new_by_cap"][cap] = {
                "route": vsp.scan_route(pc, S, C), "slots": pc.slots, "hubs": pc.hubs,
                "ms": cs.gpu_median_ms(torch, lambda pc=pc: vsp.viterbi_scan_fwd_cuda(
                    em, src_b, lab_b, w_b, start, lens, packed=pc))}
        out[name] = row
        print(json.dumps({name: row}), flush=True)

    # the trigram path's decode of a batch on the host clock: one table,
    # then a table re-weighted before every decode (as in each train step)
    rng = np.random.RandomState(19)
    tmpl = wcompile.build_decode_template(crit.transitions)
    w0 = crit.params["transitions"].detach().cpu().numpy()
    decode = {"base": lambda: base_sparse.viterbi_batch(em3, table3, lens3),
              "new": lambda: sparse.viterbi_batch(em3, table3, lens3)}
    decode_fresh = {"base": lambda: base_sparse.viterbi_batch(em3, next(fresh), lens3),
                    "new": lambda: sparse.viterbi_batch(em3, next(fresh), lens3)}
    (lab_b, score_b), (lab_n, score_n) = decode["base"](), decode["new"]()
    if not torch.equal(lab_b, lab_n):
        raise AssertionError("trigram decode: the labels differ")
    row = {"shape": list(em3.shape), "max_abs_score_diff": float((score_b - score_n).abs().max())}
    for who in ("base", "new", "new", "base"):
        row.setdefault(f"{who}_host_ms", []).append(host_median_ms(torch, decode[who], runs=5))
    fresh = iter([wcompile.apply_decode_weights(  # 6 decodes a median, 4 medians
        tmpl, w0 + (rng.randn(w0.size) * 0.01).astype(np.float32)) for _ in range(24)])
    for who in ("base", "new", "new", "base"):
        row.setdefault(f"{who}_fresh_table_host_ms", []).append(
            host_median_ms(torch, decode_fresh[who], runs=5))
    out["trigram_decode_batch"] = row
    print(json.dumps({"trigram_decode_batch": row}), flush=True)
    return out


def live_sets(torch, name, traj_n, traj_b, dead):
    """This checkout's live states (which must all be live in the
    baseline's trajectory) and how many states live only in the
    baseline's: a baseline without the FLT_MIN gate keeps alive, lifted by
    the 1e-37 floor, sums that this checkout declares dead, and what such
    states feed differs too, so the trajectories' values are logged, not
    held (``chip_smoke.py`` holds each kernel to its plain version)."""
    live, base_live = traj_n > dead, traj_b > dead
    if bool((live & ~base_live).any()):
        raise AssertionError(f"{name}: states live here and dead in the baseline")
    return live, int((base_live & ~live).sum())


def factored_ab(torch, cs, root, dev):
    """The ``--factored`` comparison (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    base = load_baseline(root, "ops.dense_scan_pallas")
    frame_us = cs.factored_chain_frame_us(torch, cs.B, dev)
    out = {"chain_frame_us": frame_us}
    for name, kw in cs.NGRAM_CASES.items():
        em, adj, wsel, lab, ws, st, acc, il = cs.factored_headline_inputs(torch, dev, **kw)
        fwd_args = (em, adj, wsel, lab, ws, st, il)
        traj_n = dsp.factored_scan_fwd_cuda(*fwd_args)
        traj_b = base.factored_scan_fwd_cuda(*fwd_args)
        live, killed = live_sets(torch, name, traj_n, traj_b, DEAD)
        g = cs.score_cotangent(torch, traj_b[:, -1], acc)
        bwd_args = (traj_b, adj, wsel, lab, st, il, g)
        run = {who: {"fwd": lambda m=m: m.factored_scan_fwd_cuda(*fwd_args),
                     "bwd": lambda m=m: m.factored_scan_bwd_cuda(*bwd_args, need_dadj=False),
                     "bwd_with_dadj": lambda m=m: m.factored_scan_bwd_cuda(*bwd_args)}
               for who, m in (("base", base), ("new", dsp))}
        b, T, S = em.shape
        row = {"shape": [b, T, S, wsel.shape[2]], "max_len": int(il.max()),
               "max_abs_traj_diff": float((traj_n - traj_b).abs()[live].max()),
               "live_only_in_baseline": killed,
               "routes": cs.factored_routes(torch, adj, lab, il, wsel.shape[2]),
               "chain_bound_ms": {"fwd": int(il.max()) * frame_us * 1e-3,
                                  "bwd": (int(il.max()) - 1) * frame_us * 1e-3},
               "work_ops": {"fwd": cs.factored_work(adj, lab, il, True),
                            "bwd": cs.factored_work(adj, lab, il, False),
                            "bwd_with_dadj": cs.factored_work(adj, lab, il, False, True),
                            "fwd_dense_count": cs.factored_work_dense(lab, il, True),
                            "bwd_dense_count": cs.factored_work_dense(lab, il, False)},
               "kernels_a_call": {who: {k: cs.kernel_launches(torch, fn, cs.FACTORED_KERNELS)
                                        for k, fn in run[who].items()} for who in run}}
        for who in ("base", "new", "new", "base"):
            for k, fn in run[who].items():
                row.setdefault(f"{who}_{k}_ms", []).append(cs.gpu_median_ms(torch, fn))
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    return out


def dense_ab(torch, cs, root, dev):
    """The ``--dense`` comparison (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    base = load_baseline(root, "ops.dense_scan_pallas")
    out = {}
    for key, (em, adj, st, lab, acc, il) in cs.dense_time_cases(torch, dev):
        name = key.lstrip("_") or "headline"
        fwd_args = (em, adj, st, lab, il)
        traj_n = dsp.dense_scan_fwd_cuda(*fwd_args)
        traj_b = base.dense_scan_fwd_cuda(*fwd_args)
        live, killed = live_sets(torch, name, traj_n, traj_b, DEAD)
        g = cs.score_cotangent(torch, traj_b[:, -1], acc)
        bwd_args = (traj_b, adj, st, lab, il, g)
        bwd_diff = {}
        for part, k, b in zip(("dem", "dadj"), dsp.dense_scan_bwd_cuda(*bwd_args),
                              base.dense_scan_bwd_cuda(*bwd_args)):
            finite = torch.isfinite(b) & torch.isfinite(k)
            bwd_diff[part] = cs.entrywise_err(torch, k[finite], b[finite])
        run = {who: {"fwd": lambda m=m: m.dense_scan_fwd_cuda(*fwd_args),
                     "bwd": lambda m=m: m.dense_scan_bwd_cuda(*bwd_args, need_dadj=False),
                     "bwd_with_dadj": lambda m=m: m.dense_scan_bwd_cuda(*bwd_args)}
               for who, m in (("base", base), ("new", dsp))}
        b, T, S = em.shape
        routes = cs.dense_routes(torch, adj, lab, il)
        chain, frame_us = cs.dense_chain_bounds(torch, dev, routes, b, int(il.max()))
        row = {"shape": [b, T, S], "max_len": int(il.max()),
               "max_abs_traj_diff": float((traj_n - traj_b).abs()[live].max()),
               "live_only_in_baseline": killed,
               "entrywise_bwd_diff": bwd_diff,
               "routes": routes, "chain_bound_ms": chain, "chain_frame_us": frame_us,
               "bound_ms": cs.dense_bounds(em, adj, lab, il),
               "work_ops": {"fwd": cs.dense_work(adj, lab, il, True),
                            "bwd": cs.dense_work(adj, lab, il, False),
                            "bwd_with_dadj": cs.dense_work(adj, lab, il, False, True),
                            "fwd_dense_count": cs.scan_work(il, S, cs.DENSE_FWD_OPS, 2),
                            "bwd_dense_count": cs.scan_work(il, S, cs.DENSE_BWD_OPS, 6)},
               "kernels_a_call": {who: {k: cs.kernel_launches(torch, fn, cs.DENSE_KERNELS)
                                        for k, fn in run[who].items()} for who in run}}
        for who in ("base", "new", "new", "base"):
            for k, fn in run[who].items():
                row.setdefault(f"{who}_{k}_ms", []).append(cs.gpu_median_ms(torch, fn))
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    return out


def seglse_ab(torch, cs, root, dev):
    """The ``--seglse`` comparison (see the module docstring)."""
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    base = load_baseline(root, "ops.seglse_pallas")
    out = {}
    for name, em, _, table in cases(torch, cs, dev):
        (_, _, _, _, esrc, edst, ew), start, _, depth = cs.sparse_fields(table)
        if not depth:
            continue
        B, S = em.shape[0], start.shape[-1]
        alpha = start.expand(B, S).contiguous()
        g = torch.rand(B, S, device=dev)
        idx, idx_b = slp.arc_index(esrc, edst, S), base.arc_index(esrc, edst, S)
        zero = torch.zeros_like(ew)
        w_s, z_s = base.take(ew, idx_b.order), base.take(zero, idx_b.order)
        out_b = base.seg_lse_fwd_cuda(alpha, w_s, z_s, idx_b)
        out_n, m, z = slp.seg_lse_fwd_cuda(alpha, ew, None, idx, stats=True)
        live = out_b > DEAD
        if not torch.equal(out_n > DEAD, live):
            raise AssertionError(f"{name}: the two forwards' live sets differ")
        torch.testing.assert_close(out_n[live], out_b[live], atol=1e-3, rtol=1e-5)
        da_b, dc_b = base.seg_lse_bwd_cuda(alpha, w_s, z_s, idx_b, g)
        da_n, dc_n = slp.seg_lse_bwd_cuda(alpha, ew, None, idx, m, z, g)
        a_req = alpha.clone().requires_grad_(True)
        w_req = ew.clone().requires_grad_(True)
        steps = {"base": lambda: base.seg_lse(a_req, esrc, edst, w_req, zero, idx_b),
                 "new": lambda: slp.seg_lse(a_req, esrc, edst, w_req, None, idx)}
        run = {"base": {"fwd": lambda: base.seg_lse_fwd_cuda(alpha, w_s, z_s, idx_b),
                        "bwd": lambda: base.seg_lse_bwd_cuda(alpha, w_s, z_s, idx_b, g)},
               "new": {"fwd": lambda: slp.seg_lse_fwd_cuda(alpha, ew, None, idx, stats=True),
                       "bwd": lambda: slp.seg_lse_bwd_cuda(alpha, ew, None, idx, m, z, g)}}
        for who, step in steps.items():
            run[who]["step_fwd"] = step
            run[who]["step_fwd_bwd"] = lambda step=step: torch.autograd.grad(
                step(), (a_req, w_req), g)
        degree = lambda p: int(torch.diff(p.long(), dim=1).max())  # noqa: E731
        row = {"B": B, "S": S, "E": int(esrc.shape[-1]), "rows": int(esrc.shape[0]),
               "max_in_degree": degree(idx.dptr), "max_out_degree": degree(idx.sptr),
               "max_abs_out_diff": float((out_n - out_b).abs()[live].max()),
               "max_abs_dalpha_diff": float((da_n - da_b).abs().max()),
               "max_abs_dcontrib_diff": float(
                   (dc_n - base.untake(dc_b, idx_b.order)).abs().max()),
               "step_kernels": {who: {k: cs.kernel_counts(torch, run[who][k])
                                      for k in ("step_fwd", "step_fwd_bwd")}
                                for who in run}}
        for who in ("base", "new", "new", "base"):
            for k, fn in run[who].items():
                row.setdefault(f"{who}_{k}_ms", []).append(cs.gpu_median_ms(torch, fn))
        row["new_fwd_no_stats_ms"] = cs.gpu_median_ms(
            torch, lambda: slp.seg_lse_fwd_cuda(alpha, ew, None, idx))
        for r in (False, True):
            row[f"new_fwd_staged_{r}_ms"] = cs.gpu_median_ms(
                torch, lambda r=r: slp.seg_lse_fwd_cuda(alpha, ew, None, idx, stats=True,
                                                        staged=r))
        row["new_fwd_staged"] = slp.stage_words(S, row["E"], None) <= slp.STAGE_WORDS
        row["new_bwd_no_dcontrib_ms"] = cs.gpu_median_ms(
            torch, lambda: slp.seg_lse_bwd_cuda(alpha, ew, None, idx, m, z, g,
                                                need_dcontrib=False))
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, help="root of the other checkout")
    parser.add_argument("--clusters", type=int, nargs="*", default=[],
                        help="also time this checkout's pair at these cluster sizes")
    parser.add_argument("--phases", action="store_true",
                        help="also time this checkout's pair at each closure depth")
    parser.add_argument("--decode", action="store_true",
                        help="compare the 4-gram path's Viterbi decode instead")
    parser.add_argument("--viterbi", action="store_true",
                        help="compare the whole-scan Viterbi kernel and decode instead")
    parser.add_argument("--caps", type=int, nargs="*", default=[],
                        help="with --viterbi, also time this checkout's kernel at these "
                             "per-lane caps")
    parser.add_argument("--factored", action="store_true",
                        help="compare the factored scan pair instead")
    parser.add_argument("--seglse", action="store_true",
                        help="compare the seg_lse pair instead")
    parser.add_argument("--dense", action="store_true",
                        help="compare the dense scan pair instead")
    parser.add_argument("--accuracy", type=float, nargs="*", default=[],
                        help="also hold each forward to float64 with the emissions "
                             "scaled by each of these")
    parser.add_argument("--frames", type=int, default=300,
                        help="frames of the backoff paths' cases")
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp
    from gtn_applications_tpu_torch.ops.semiring import DEAD, logaddexp

    if not torch.cuda.is_available():
        raise SystemExit("compare_sparse_scan needs a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": utils.card_name_and_power_limit(), "cases": {}}
    if args.decode:
        result["cases"] = decode_ab(torch, cs, args.baseline, dev)
        return _report("compare_decode", result, args.out)
    if args.viterbi:
        result["cases"] = viterbi_ab(torch, cs, args.baseline, dev, args.caps)
        return _report("compare_viterbi", result, args.out)
    if args.factored:
        result["cases"] = factored_ab(torch, cs, args.baseline, dev)
        return _report("compare_factored", result, args.out)
    if args.seglse:
        result["cases"] = seglse_ab(torch, cs, args.baseline, dev)
        return _report("compare_seglse", result, args.out)
    if args.dense:
        result["cases"] = dense_ab(torch, cs, args.baseline, dev)
        return _report("compare_dense", result, args.out)
    base = load_baseline(args.baseline)
    for name, em, lens, table in cases(torch, cs, dev, args.frames):
        (src, dst, label, w, esrc, edst, ew), start, accept, depth = cs.sparse_fields(table)
        B, S, C = em.shape[0], start.shape[-1], em.shape[2]
        alpha0 = start.expand(B, S).contiguous()
        acc = cur = alpha0
        for _ in range(depth):
            cur = slp.seg_lse_fwd_plain(cur, esrc, edst, ew, torch.zeros_like(ew))
            acc = logaddexp(acc, cur)
        alpha0 = acc.contiguous()
        runs = {}
        for who, mod in (("base", base), ("new", ssp)):
            plan = mod.scan_plan(src, dst, label, esrc, edst, S, C)
            traj, _ = mod.sparse_scan_fwd_cuda(em, alpha0, lens, plan, w, ew, depth)
            gf = cs.score_cotangent(torch, traj[:, -1], accept)
            runs[who] = (
                lambda mod=mod, plan=plan: mod.sparse_scan_fwd_cuda(
                    em, alpha0, lens, plan, w, ew, depth),
                lambda mod=mod, plan=plan, traj=traj, gf=gf: mod.sparse_scan_bwd_cuda(
                    em, traj, lens, plan, w, ew, depth, gf),
                traj, plan)
        live = runs["base"][2] > DEAD
        row = {"max_abs_traj_diff": float(
            (runs["base"][2] - runs["new"][2]).abs()[live].max()),
               "S": S, "A": int(src.shape[1]), "E": int(esrc.shape[1]), "depth": depth,
               "em": list(em.shape), "max_len": int(lens.max()),
               "cluster": ssp.choose_cluster(runs["new"][3], B, depth, dev)}
        for scale in args.accuracy:
            ems = (em * scale).contiguous()
            f64 = [x.double() for x in (ems, alpha0, w, ew)]
            ref, _ = ssp.sparse_scan_fwd_plain(f64[0], f64[1], lens, runs["new"][3], f64[2],
                                               f64[3], depth)
            keep = (ref > DEAD) & (ref > -80.0)
            plain, _ = ssp.sparse_scan_fwd_plain(ems, alpha0, lens, runs["new"][3], w, ew,
                                                 depth)
            trajs = {who: mod.sparse_scan_fwd_cuda(ems, alpha0, lens, runs[who][3], w, ew,
                                                   depth)[0]
                     for who, mod in (("base", base), ("new", ssp))}
            trajs["plain32"] = plain
            row.setdefault("err64", {})[str(scale)] = {
                who: float((tr.double() - ref)[keep].abs().max())
                for who, tr in trajs.items()}
        for who in ("base", "new", "new", "base"):
            fwd, bwd = runs[who][:2]
            row.setdefault(f"{who}_fwd_ms", []).append(cs.gpu_median_ms(torch, fwd))
            row.setdefault(f"{who}_bwd_ms", []).append(cs.gpu_median_ms(torch, bwd))
        plan, traj = runs["new"][3], runs["new"][2]
        gf = cs.score_cotangent(torch, traj[:, -1], accept)
        for k in args.clusters:
            fit = [ssp.max_active_clusters(plan, depth, bwd, k, dev) for bwd in (False, True)]
            if not min(fit):
                row[f"k{k}"] = {"fit": fit}
                continue
            row[f"k{k}"] = {
                "fit": fit,
                "fwd_ms": cs.gpu_median_ms(torch, lambda k=k: ssp.sparse_scan_fwd_cuda(
                    em, alpha0, lens, plan, w, ew, depth, cluster=k)),
                "bwd_ms": cs.gpu_median_ms(torch, lambda k=k: ssp.sparse_scan_bwd_cuda(
                    em, traj, lens, plan, w, ew, depth, gf, cluster=k))}
        if args.phases:
            k = row["cluster"]
            row["by_depth"] = {}
            for d in range(depth + 1):
                traj_d, _ = ssp.sparse_scan_fwd_cuda(em, alpha0, lens, plan, w, ew, d,
                                                     cluster=k)
                row["by_depth"][d] = {
                    "fwd_ms": cs.gpu_median_ms(torch, lambda d=d: ssp.sparse_scan_fwd_cuda(
                        em, alpha0, lens, plan, w, ew, d, cluster=k)),
                    "bwd_ms": cs.gpu_median_ms(
                        torch, lambda d=d, traj_d=traj_d: ssp.sparse_scan_bwd_cuda(
                            em, traj_d, lens, plan, w, ew, d, gf, cluster=k))}
        result["cases"][name] = row
        print(json.dumps({name: row}), flush=True)
    _report("compare_sparse_scan", result, args.out)


def _report(key, result, out):
    line = json.dumps({key: result})
    print(line)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")


if __name__ == "__main__":
    main()
