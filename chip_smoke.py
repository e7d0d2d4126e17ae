#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero and
prints no result):

1. device: fail without CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build: compile the CUDA kernels of ``gtn_applications_tpu_torch/ops/csrc``
   with nvcc (one process per source, in parallel) and print the time;
3. gather kernels against their plain versions at x [32, 250, 80],
   idx [32, 89] with -1 padding, and at a wide S = 4096 with many
   duplicates: the forward bitwise, the backward within 1e-5;
4. CTC kernels against their plain versions at the bench headline
   (B=32, T=250, L=44, N=80): alpha and score within atol 1e-3 + rtol 1e-5,
   grad within 1e-5; the loss and logit gradients against F.ctc_loss
   (same 1/len-then-mean reduction) within 1e-3;
5. the dense backtrace kernel against its plain walk at the ASG bench
   headline (B=32, T=250, C=80, backpointers of the ASG Viterbi scan) and
   at B=8, T=1000 (a table past shared memory): paths bitwise equal;
6. the dense-scan kernels against their plain versions at the STC bench
   headline (B=32, T=250, L=30, N=80, so S=96) and at S=304 (B=8, T=128,
   L=100), on STC tables and on a dense random case of the same shape in
   which every state is live and z stays far from the floor: the
   trajectory within atol 1e-3 + rtol 1e-5 on live states, dem and dadj
   entry by entry within 1e-5 (|p| + the median nonzero |p|);
7. three main paths, CTC, ASG and STC: ``train.train`` of the port for 2
   epochs (64 synthetic samples, batch 32: 4 steps plus validation) with
   the model and criterion sections of configs/iamdb/tds2d.json,
   tds2d_asg.json and tds2d_stc.json unchanged, then ``test.run_test`` on
   the checkpoint; the launch counters are zeroed just before each path
   and read just after: each kernel of the path must have launched once
   per train step (backward kernels) or once per train step and per
   evaluation batch (forward kernels and the backtrace, which the decode
   of every batch reaches), and no kernel of another path at all;
8. the trainer's first batch of each path through its trained model: for
   CTC the logits on the card against the CPU within 1e-3; the loss and
   the logit gradient (and ASG's transitions gradient) on the card against
   the CPU on the same logits (CTC 1e-4 and 1e-6, ASG and STC 1e-4 and
   1e-5); and the path's kernels against their plain versions on the
   inputs the train step gives them, at the tolerances of phases 3-6;
9. times: CUDA-event medians of 30 runs after warm-up at the phase 4-6
   headline shapes for each kernel, its plain version and F.ctc_loss, the
   host-clock median of 20 full train steps of each path, and the latency
   of one frame of the CTC recursion's dependent chain (``ctc_chain_probe``)
   for the CTC kernels' chain bound.

Output: the nvidia-smi line, a ``{"timing": ...}`` line, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per live state and frame: lse3 (3 max, 3 sub, 3 exp,
# 2 add, floor max, log, add) plus the emission add; the backward adds the
# posterior (add, sub, min, exp, mul) and eb = em + beta
ALPHA_OPS = 15
GRAD_OPS = 21
# fp32 operations per state and frame of the dense scan besides its S x S
# products: forward max, sub, exp, log, floor, two adds and the masks; the
# backward also the dz division and the g product
DENSE_FWD_OPS = 8
DENSE_BWD_OPS = 10

B, T, L, N = 32, 250, 44, 80
BLANK = N - 1


def log(msg):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_median_ms(torch, fn, runs=30, warmup=5):
    """Median device time of ``fn`` over ``runs`` calls.  A spin kernel
    keeps the device busy while the host queues all the calls between
    their event pairs, so a call's time is its device time, not the host's
    launch overhead, unless the host queues slower than the spin lasts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(runs)
    ]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_device(torch):
    from gtn_applications_tpu_torch import utils

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    card = utils.card_name_and_power_limit()
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    from gtn_applications_tpu_torch.ops import _build

    _build.load_library("gather")
    log(f"build: {_build.build_seconds:.1f} s (nvcc, {len(_build.SOURCES)} sources)")
    return _build.build_seconds


def _gather_case(torch, dev, b, t, c, s, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32)).to(dev)
    idx = rng.integers(0, c, (b, s)).astype(np.int32)
    idx[:, 0::2] = c - 1  # every even column repeats one channel, as blanks do
    idx[rng.random((b, s)) < 0.1] = -1
    g = rng.random((b, t, s)).astype(np.float32)
    g /= g.sum(-1, keepdims=True)  # rows sum to 1, as CTC posteriors do
    return x, torch.from_numpy(idx).to(dev), torch.from_numpy(g).to(dev)


def merge_errs(errs, more):
    for key, value in more.items():
        errs[key] = max(errs.get(key, 0.0), value)
    return errs


def hold_gather_kernels(torch, x, idx, g, what):
    """Both gather kernels against their plain versions: the forward
    bitwise, the backward within 1e-5."""
    from gtn_applications_tpu_torch.ops import gathers

    C = x.shape[2]
    gathers.check_indices(idx, C)
    out = gathers.gather_fwd_cuda(x, idx)
    dx = gathers.gather_bwd_cuda(g, idx, C)
    torch.cuda.synchronize()
    ref = gathers.gather_channels_plain(x, idx)
    dref = gathers.gather_channels_bwd_plain(g, idx, C)
    if not torch.equal(out, ref):
        raise AssertionError(f"gather fwd differs from plain at {what}")
    err = float((dx - dref).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"gather bwd max|d|={err} > 1e-5 at {what}")
    log(f"gather {what}: fwd bitwise equal, bwd max|d| {err:.3g}")
    return {"gather_fwd": float((out - ref).abs().max()), "gather_bwd": err}


def hold_ctc_kernels(torch, em, start, accept, skip, il, g, what):
    """Both CTC kernels against their plain versions: alpha and score
    within atol 1e-3 + rtol 1e-5, the gradient within 1e-5.  Returns the
    errors and the kernel's gradient."""
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    a_k = lp_mod.ctc_alpha_cuda(em, start, skip, il)
    a_p = lp_mod.ctc_alpha_plain(em, start, skip, il)
    torch.testing.assert_close(a_k, a_p, atol=1e-3, rtol=1e-5)
    alpha_err = float((a_k - a_p).abs()[a_p > DEAD].max())
    s_k = lp_mod._final_score(a_k[:, -1], accept)
    s_p = lp_mod._final_score(a_p[:, -1], accept)
    torch.testing.assert_close(s_k, s_p, atol=1e-3, rtol=1e-5)
    gr_k = lp_mod.ctc_grad_cuda(em, a_k, accept, skip, il, s_k, g)
    gr_p = lp_mod.ctc_grad_plain(em, a_p, accept, skip, il, s_p, g)
    torch.cuda.synchronize()
    grad_err = float((gr_k - gr_p).abs().max())
    if not grad_err <= 1e-5:
        raise AssertionError(f"ctc grad max|d|={grad_err} > 1e-5 at {what}")
    log(f"ctc {what}: alpha max|d| (live states) {alpha_err:.3g}, score max|d| "
        f"{float((s_k - s_p).abs().max()):.3g}, grad max|d| {grad_err:.3g}")
    return {"ctc_alpha": alpha_err, "ctc_grad": grad_err}, gr_k


def phase_gather(torch, dev):
    errs = {}
    for shape in [(B, T, N, 2 * L + 1), (8, T, N, 4096)]:
        x, idx, g = _gather_case(torch, dev, *shape, seed=shape[-1])
        merge_errs(errs, hold_gather_kernels(torch, x, idx, g, shape))
    return errs


def headline_inputs(torch, dev, seed=0):
    """Logits [B, T, N], targets [B, L] with repeated labels (some skips
    disallowed), target lengths over 1..L and input lengths over 200..T."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, N).astype(np.float32)
    tl = rng.randint(1, L + 1, size=B)
    tl[0], tl[1] = L, 1
    targets = np.zeros((B, L), np.int64)
    for b in range(B):
        t = rng.randint(0, N - 1, size=tl[b])
        t[1::4] = t[0::4][: len(t[1::4])]
        targets[b, : tl[b]] = t
    il = rng.randint(200, T + 1, size=B)
    il[0] = T
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (to(logits, torch.float32), to(targets, torch.int64),
            to(tl, torch.int32), to(il, torch.int32))


def ctc_kernel_inputs(torch, logits, targets, tl, blank=BLANK):
    from gtn_applications_tpu_torch.ops import gathers, lattice

    lp = torch.log_softmax(logits, dim=2)
    labels, skip_ok = lattice.ctc_state_tables(targets, blank)
    labels = labels.to(torch.int32).contiguous()
    em = gathers.gather_channels_plain(lp, labels).contiguous()
    start, accept = lattice.ctc_start_accept(tl, em.shape[2])
    return lp, labels, em, start.contiguous(), accept.contiguous(), \
        skip_ok.to(torch.float32).contiguous()


def phase_ctc(torch, dev):
    from gtn_applications_tpu_torch.ops import lattice

    logits, targets, tl, il = headline_inputs(torch, dev)
    lp, labels, em, start, accept, skip = ctc_kernel_inputs(torch, logits, targets, tl)
    g = -1.0 / (B * tl.to(torch.float32))  # d(mean of -score/len) / d score
    errs, _ = hold_ctc_kernels(torch, em, start, accept, skip, il, g,
                               (B, T, L, N))

    # value sanity: the port's loss and logit gradients against F.ctc_loss
    x = logits.clone().requires_grad_(True)
    loss = lattice.ctc_loss(torch.log_softmax(x, 2), targets, tl, BLANK,
                            "mean", il)
    (gx,) = torch.autograd.grad(loss, x)
    y = logits.clone().requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(y, 2).transpose(0, 1), targets, il, tl, blank=BLANK,
        reduction="mean", zero_infinity=False,
    )
    (gy,) = torch.autograd.grad(ref, y)
    d_loss = abs(float(loss.detach()) - float(ref.detach()))
    d_grad = float((gx - gy).abs().max())
    log(f"ctc loss {float(loss.detach()):.6f} vs F.ctc_loss {float(ref.detach()):.6f}: "
        f"|d| {d_loss:.3g}, logit grad max|d| {d_grad:.3g}")
    if not (d_loss <= 1e-3 and d_grad <= 1e-3):
        raise AssertionError("CTC loss disagrees with F.ctc_loss")
    return dict(errs, f_ctc_loss_abs_diff=d_loss, f_ctc_grad_max_abs_diff=d_grad)


# ASG / STC bench headlines (bench.py): C = 80 channels for ASG (no
# replabels, no garbage); STC targets of L = 30 tokens out of 80, so
# S = 3L + 2 = 92 states bucketed to 96; S = 304 is an IAM-like line
# (L = 100), over T = 128 frames: every path through 100 tokens needs at
# least 100 frames, so at fewer the score is NEG and the backward all zero
ASG_C = 80
STC_L = 30
WIDE_STC = (8, 128, 100)  # B, T, L: S = 304


def ragged_lengths(rng, b, t):
    il = rng.randint(t * 4 // 5, t + 1, size=b)
    il[0] = t
    return il


def hold_dense_bt(torch, bp, last, what):
    """The backtrace kernel against its plain walk: paths bitwise equal."""
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    path_k = vsp.dense_backtrace_cuda(bp, last)
    path_p = vsp.dense_backtrace_plain(bp, last)
    torch.cuda.synchronize()
    if not torch.equal(path_k, path_p):
        raise AssertionError(f"dense_backtrace differs from its plain walk at {what}")
    log(f"dense_bt {what}: paths bitwise equal")
    return {"dense_bt": 0.0}


def asg_headline_inputs(torch, dev, b=B, t=T, c=ASG_C, seed=1):
    """Outputs [b, t, c], transitions [c + 1, c] and input lengths; and
    the backpointers and last states of their ASG Viterbi scan."""
    from gtn_applications_tpu_torch.ops import lattice

    rng = np.random.RandomState(seed)
    out = torch.as_tensor(rng.randn(b, t, c).astype(np.float32), device=dev)
    trans = torch.as_tensor((rng.randn(c + 1, c) * 0.5).astype(np.float32),
                            device=dev)
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    bp, last, _ = lattice.asg_viterbi_backpointers(out, trans, il)
    return bp.contiguous(), last.contiguous()


def phase_dense_bt(torch, dev):
    errs = {}
    for shape in [(B, T, ASG_C), (8, 1000, ASG_C)]:
        bp, last = asg_headline_inputs(torch, dev, *shape)
        merge_errs(errs, hold_dense_bt(torch, bp, last, shape))
    return errs


def dense_scan_inputs(torch, crit, logits, prepared):
    """The dense scan's inputs as STC.loss builds them: em_state [B, T, S],
    adj [B, S, S], start, has_lab and accept [B, S]."""
    em = crit.star_channels(torch.log_softmax(logits, dim=2), prepared["select"])
    d = prepared["dense"]
    adj = d["adj0"] + math.exp(prepared["log_penalty"]) * d["adj_star"]
    em_state = torch.einsum("btn,bsn->bts", em, d["lab_oh"])
    has_lab = (d["lab_oh"].sum(-1) > 0).to(torch.float32)
    return (em_state.contiguous(), adj.contiguous(), d["start"].contiguous(),
            has_lab.contiguous(), d["accept"])


def stc_headline_inputs(torch, dev, b=B, t=T, length=STC_L, n=N, seed=2):
    from gtn_applications_tpu_torch.criterions import STC
    from gtn_applications_tpu_torch.train import to_device

    rng = np.random.RandomState(seed)
    crit = STC(0, p0=1.0, plast=0.1, thalf=100, reduction="mean", shift_targets=1)
    logits = torch.as_tensor(rng.randn(b, t, n + 1).astype(np.float32), device=dev)
    prepared = to_device(
        crit.prepare([rng.randint(0, n, size=length).tolist() for _ in range(b)]),
        dev)
    il = torch.as_tensor(ragged_lengths(rng, b, t), dtype=torch.int32, device=dev)
    return dense_scan_inputs(torch, crit, logits, prepared) + (il,)


def score_cotangent(torch, alpha, accept):
    """d sum(logsumexp(alpha + accept)) / d alpha: the cotangent the STC
    score gives the final alpha."""
    from gtn_applications_tpu_torch.ops.semiring import logsumexp

    a = alpha.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(logsumexp(a + accept, dim=1).sum(), a)
    return g.contiguous()


def dense_random_inputs(torch, dev, b, t, s, seed=3):
    """A dense-scan case in which every state is live on every frame and
    z stays far from the 1e-37 floor: every adjacency entry is at least
    0.05 / S, every state starts (start 0) and holds mass (has_lab 1), and
    the shifted e has a largest entry of 1 each frame, so z >= 0.05 / S.
    Emissions N(-4, 1), accept 0, input lengths over 4t/5..t."""
    rng = np.random.RandomState(seed)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    em = to((rng.randn(b, t, s) - 4).astype(np.float32))
    adj = to((rng.uniform(0.05, 1.0, (b, s, s)) / s).astype(np.float32))
    zeros = torch.zeros(b, s, device=dev)
    il = to(ragged_lengths(rng, b, t).astype(np.int32))
    return em, adj, zeros, torch.ones(b, s, device=dev), zeros, il


def entrywise_err(torch, k, p):
    """Largest |k - p| / (|p| + m) over the entries, m the median of the
    nonzero |p|: each entry is held to its own size, and an entry near zero
    to the typical one (so no large entry sets the scale of the others)."""
    a = p.abs().double()
    nz = a[a > 0]
    m = float(nz.median()) if nz.numel() else 1.0
    return float(((k - p).abs().double() / (a + m)).max())


def hold_dense_scan_kernels(torch, em_state, adj, start, has_lab, accept, il, what,
                            all_live=False):
    """Both dense-scan kernels against their plain versions on the same
    inputs: the trajectory within atol 1e-3 + rtol 1e-5 on live states;
    dem and dadj entry by entry, |k - p| <= 1e-5 (|p| + median nonzero
    |p|); the backward without dadj gives the same dem.  With ``all_live``
    every state of every frame must be live."""
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops.semiring import DEAD

    tr_k = dsp.dense_scan_fwd_cuda(em_state, adj, start, has_lab, il)
    tr_p = dsp.dense_scan_fwd_plain(em_state, adj, start, has_lab, il)
    live = tr_p > DEAD
    if not torch.equal(tr_k > DEAD, live):
        raise AssertionError(f"dense_scan_fwd: live states differ at {what}")
    if all_live and not bool(live.all()):
        raise AssertionError(f"dense_scan_fwd: dead states in the all-live case {what}")
    torch.testing.assert_close(tr_k[live], tr_p[live], atol=1e-3, rtol=1e-5)
    fwd_err = float((tr_k[live] - tr_p[live]).abs().max())
    g = score_cotangent(torch, tr_p[:, -1], accept)
    dem_k, dadj_k = dsp.dense_scan_bwd_cuda(tr_p, adj, start, has_lab, il, g)
    dem_p, dadj_p = dsp.dense_scan_bwd_plain(tr_p, adj, start, has_lab, il, g)
    dem_only, none = dsp.dense_scan_bwd_cuda(tr_p, adj, start, has_lab, il, g,
                                            need_dadj=False)
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for name, k, p in (("dem", dem_k, dem_p), ("dadj", dadj_k, dadj_p),
                       ("dem without dadj", dem_only, dem_p)):
        # dadj of a pair with no arc can reach fp32's range (dz = g / z
        # with z at the 1e-37 floor): both versions must agree on which
        # entries overflow, and are compared on the rest
        finite = torch.isfinite(p)
        if not torch.equal(torch.isfinite(k), finite):
            raise AssertionError(f"dense_scan_bwd {name}: non-finite entries "
                                 f"differ at {what}")
        k, p = k[finite], p[finite]
        rels[name] = entrywise_err(torch, k, p)
        if not rels[name] <= 1e-5:
            raise AssertionError(f"dense_scan_bwd {name}: entrywise error "
                                 f"{rels[name]} > 1e-5 at {what}")
        errs[name] = float((k - p).abs().max())
    if none is not None:
        raise AssertionError("dense_scan_bwd returned dadj without need_dadj")
    log(f"dense_scan {what}: traj max|d| (live states) {fwd_err:.3g}, entrywise "
        f"error dem {rels['dem']:.3g}, dadj {rels['dadj']:.3g} (dadj max|d| "
        f"{errs['dadj']:.3g}, largest {float(dadj_p.abs().max()):.3g})")
    return {"dense_scan_fwd": fwd_err,
            "dense_scan_bwd": max(errs["dem"], errs["dadj"]),
            "dense_scan_bwd_rel": max(rels.values())}


def phase_dense_scan(torch, dev):
    errs = {}
    for b, t, length in [(B, T, STC_L), WIDE_STC]:
        inputs = stc_headline_inputs(torch, dev, b, t, length)
        what = (b, t, inputs[0].shape[2])
        merge_errs(errs, hold_dense_scan_kernels(torch, *inputs, what))
        # the same shape with every state live and z far from the floor
        merge_errs(errs, hold_dense_scan_kernels(
            torch, *dense_random_inputs(torch, dev, *what), ("all live",) + what,
            all_live=True))
    return errs


# path -> (config file, its forward kernels (and decode), its backward kernels)
PATHS = {
    "ctc": ("tds2d.json", ("gather_fwd", "ctc_alpha"), ("gather_bwd", "ctc_grad")),
    "asg": ("tds2d_asg.json", ("gather_fwd", "dense_bt"), ("gather_bwd",)),
    "stc": ("tds2d_stc.json", ("dense_scan_fwd",), ("dense_scan_bwd",)),
}
SPLITS = {"train": 64, "validation": 16, "test": 16}  # synthetic split sizes


def main_path_config(path):
    """The config's model and criterion sections unchanged; synthetic
    data, 2 epochs."""
    with open(ROOT / "configs" / "iamdb" / PATHS[path][0]) as fid:
        base = json.load(fid)
    config = {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 64},
        "model_type": base["model_type"],
        "model": base["model"],
        "criterion_type": base.get("criterion_type", "ctc"),
        "optim": dict(base["optim"], epochs=2),
    }
    if "criterion" in base:
        config["criterion"] = base["criterion"]
    return config


def phase_main_path(torch, dev, path, config):
    from gtn_applications_tpu_torch import test as test_mod
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build

    work = WORK / path
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / "config.json"
    cfg.write_text(json.dumps(config))
    args = train_mod.parse_args(["--config", str(cfg), "--checkpoint_path", str(work)])
    targs = test_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(work), "--split", "test"]
    )

    _build.reset_launches()
    t0 = time.perf_counter()
    model, history = train_mod.train(args)
    meters = test_mod.run_test(targs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    epochs, batch = config["optim"]["epochs"], config["optim"]["batch_size"]
    steps = epochs * -(-SPLITS["train"] // batch)
    evals = epochs * -(-SPLITS["validation"] // batch) + -(-SPLITS["test"] // batch)
    for h in history:
        for key in ("train_loss", "val_loss", "val_cer", "val_wer"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"{path} epoch {h['epoch']}: {key} = {h[key]}")
    if not (meters.num_samples == SPLITS["test"] and meters.num_tokens > 0
            and math.isfinite(meters.avg_loss) and math.isfinite(meters.cer)
            and math.isfinite(meters.wer)):
        raise AssertionError(f"{path} test split: {meters}")
    _, fwd, bwd = PATHS[path]
    for name, n in launches.items():
        need = steps + evals if name in fwd else steps if name in bwd else 0
        if (n < need) if need else n:
            raise AssertionError(
                f"{path}: kernel {name} launched {n} times, expected "
                + (f">= {need}" if need else "none (not on this path)"))
    log(f"main path {path}: {seconds:.1f} s, history {json.dumps(history)}, "
        f"test loss {meters.avg_loss:.4f} CER {meters.cer:.2f} WER {meters.wer:.2f}, "
        f"launches {json.dumps(launches)}")
    return {"model": model, "launches": launches, "history": history,
            "seconds": seconds, "steps": steps, "evals": evals,
            "test": {"loss": meters.avg_loss, "cer": meters.cer, "wer": meters.wer}}


def first_batch(torch, config, path):
    """The trainer's first batch, its criterion (with the trained
    parameters of the path's checkpoint) and its prepared targets."""
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.datasets import synthetic

    pre = synthetic.Preprocessor(None, num_features=config["data"]["num_features"])
    trainset = synthetic.Dataset(None, pre, split="train", augment=True)
    loader = utils.data_loader(trainset, config, seed=config["seed"])
    inputs, _, targets = next(iter(loader))
    crit, _ = utils.load_criterion(config["criterion_type"], pre,
                                   config.get("criterion", {}))
    state = utils.load_checkpoint(str(WORK / path), load_last=True)
    crit.params = state["criterion"]
    return inputs, crit, crit.prepare(targets)


def card_vs_cpu(torch, dev, crit, logits, prepared, tol_loss, tol_grad, path):
    """The criterion's loss and gradients (logits, and its parameters) on
    the card against the CPU on the same logits."""
    from gtn_applications_tpu_torch.train import to_device

    def loss_and_grads(device):
        x = logits.detach().to(device).clone().requires_grad_(True)
        params = {k: v.detach().to(device).clone().requires_grad_(True)
                  for k, v in crit.params.items()}
        loss = crit.loss(params, x, to_device(prepared, device))
        grads = torch.autograd.grad(loss, [x] + list(params.values()))
        return float(loss.detach()), [g.cpu() for g in grads]

    loss_g, grads_g = loss_and_grads(dev)
    loss_c, grads_c = loss_and_grads(torch.device("cpu"))
    d_loss = abs(loss_g - loss_c)
    d_grads = [float((a - b).abs().max()) for a, b in zip(grads_g, grads_c)]
    names = ["logit"] + list(crit.params)
    log(f"main batch {path} {list(logits.shape)}: loss {loss_g:.6f} card vs cpu "
        f"|d| {d_loss:.3g}, "
        + ", ".join(f"{n} grad max|d| {d:.3g}" for n, d in zip(names, d_grads)))
    if not (d_loss <= tol_loss and all(d <= tol_grad for d in d_grads)):
        raise AssertionError(f"{path}: the card and the CPU disagree on the main batch")
    return {f"{path}_card_vs_cpu_loss_abs_diff": d_loss,
            **{f"{path}_card_vs_cpu_{n}_grad_max_abs_diff": d
               for n, d in zip(names, d_grads)}}


def phase_main_batch(torch, dev, model, config):
    """The CTC trainer's first batch through the trained model: the encoder
    on the card against the CPU, the CTC loss and logit gradient on the
    card against the CPU on the same logits, and the four kernels against
    their plain versions on the inputs the train step gives them (no input
    lengths, as the config sets none: every frame is live)."""
    import copy

    inputs, crit, prepared = first_batch(torch, config, "ctc")
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
        d_out = float((logits.cpu() - cpu_model(torch.from_numpy(inputs))).abs().max())
    log(f"main batch ctc: card vs cpu logits max|d| {d_out:.3g}")
    if not d_out <= 1e-3:
        raise AssertionError("the card and the CPU disagree on the logits")
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-6, "ctc")

    tgts, tl = (p.to(dev) for p in prepared)
    lp, labels, em, start, accept, skip = ctc_kernel_inputs(
        torch, logits, tgts, tl, crit.blank)
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    g = -1.0 / (bsz * tl.to(torch.float32).clamp(min=1))
    what = (bsz, frames, tgts.shape[1], logits.shape[2])
    errs, grad = hold_ctc_kernels(torch, em, start, accept, skip, il, g, what)
    merge_errs(errs, hold_gather_kernels(torch, lp, labels, grad, what))
    return errs, dict(diffs, card_vs_cpu_logits_max_abs_diff=d_out,
                      main_batch_shape=list(what))


def phase_main_batch_asg(torch, dev, model, config):
    """The ASG trainer's first batch: loss, logit and transitions gradients
    on the card against the CPU, and the backtrace kernel on the decode's
    backpointers; the gather kernels on the force-aligned emissions."""
    from gtn_applications_tpu_torch.ops import lattice

    inputs, crit, prepared = first_batch(torch, config, "asg")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-5, "asg")
    trans = crit.params["transitions"].to(dev)
    bp, last, _ = lattice.asg_viterbi_backpointers(logits, trans)
    what = tuple(logits.shape)
    errs = hold_dense_bt(torch, bp.contiguous(), last.contiguous(), what)
    targets = prepared[0].to(dev).to(torch.int32).contiguous()
    g = torch.rand(logits.shape[0], logits.shape[1], targets.shape[1], device=dev)
    merge_errs(errs, hold_gather_kernels(torch, logits.contiguous(), targets, g, what))
    return errs, dict(diffs, asg_main_batch_shape=list(what))


def phase_main_batch_stc(torch, dev, model, config):
    """The STC trainer's first batch: loss and logit gradient on the card
    against the CPU, and both dense-scan kernels on its inputs."""
    from gtn_applications_tpu_torch.train import to_device

    inputs, crit, prepared = first_batch(torch, config, "stc")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
    diffs = card_vs_cpu(torch, dev, crit, logits, prepared, 1e-4, 1e-5, "stc")
    scan_inputs = dense_scan_inputs(torch, crit, logits, to_device(prepared, dev))
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    what = (bsz, frames, scan_inputs[0].shape[2])
    errs = hold_dense_scan_kernels(torch, *scan_inputs, il, what)
    return errs, dict(diffs, stc_main_batch_shape=list(what))


def time_train_step(torch, dev, model, config):
    """Host-clock median ms of 20 full train steps (after 5) on the first
    batch of the train split, without augmentation."""
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.datasets import synthetic

    pre = synthetic.Preprocessor(None, num_features=config["data"]["num_features"])
    ds = synthetic.Dataset(None, pre, split="train")
    optim = config["optim"]
    inputs, _, tgts = utils.padding_collate(
        [ds[i] for i in range(optim["batch_size"])])
    crit, _ = utils.load_criterion(config["criterion_type"], pre,
                                   config.get("criterion", {}))
    train_mod.criterion_to_device(crit, dev)
    x = torch.from_numpy(inputs).to(dev)
    step = train_mod.make_train_step(
        model, crit, optim["learning_rate"],
        optim.get("crit_learning_rate", optim["learning_rate"]),
        optim["max_grad_norm"],
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = []
    for i in range(25):
        prepared = train_mod.to_device(crit.prepare(tgts), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, prepared, gen, 1.0)
        torch.cuda.synchronize()
        if i >= 5:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(step_ms), list(inputs.shape)


def scan_work(il, S, per_state, per_pair):
    """fp32 operations of the dense scan over the live frames of this
    run's inputs: per frame ``per_pair`` per (u, s) pair of the S x S
    products and ``per_state`` per state."""
    frames = int(il.clamp(min=1).sum())
    return frames * (per_pair * S * S + per_state * S)


def phase_times(torch, dev, paths):
    from gtn_applications_tpu_torch.ops import _build, gathers, lattice
    from gtn_applications_tpu_torch.ops import dense_scan_pallas as dsp
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod
    from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp

    F = torch.nn.functional
    logits, targets, tl, il = headline_inputs(torch, dev)
    lp, labels, em, start, accept, skip = ctc_kernel_inputs(torch, logits, targets, tl)
    S = em.shape[2]
    alpha = lp_mod.ctc_alpha_cuda(em, start, skip, il)
    score = lp_mod._final_score(alpha[:, -1], accept)
    g = -1.0 / (B * tl.to(torch.float32))
    grad = lp_mod.ctc_grad_cuda(em, alpha, accept, skip, il, score, g)

    t = {}
    t["gather_fwd"] = gpu_median_ms(torch, lambda: gathers.gather_fwd_cuda(lp, labels))
    t["gather_fwd_plain"] = gpu_median_ms(
        torch, lambda: gathers.gather_channels_plain(lp, labels))
    t["gather_bwd"] = gpu_median_ms(
        torch, lambda: gathers.gather_bwd_cuda(grad, labels, N))
    t["gather_bwd_plain"] = gpu_median_ms(
        torch, lambda: gathers.gather_channels_bwd_plain(grad, labels, N))
    t["ctc_alpha"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_alpha_cuda(em, start, skip, il))
    t["ctc_alpha_plain"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_alpha_plain(em, start, skip, il), runs=20)
    t["ctc_grad"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_grad_cuda(em, alpha, accept, skip, il, score, g))
    t["ctc_grad_plain"] = gpu_median_ms(
        torch, lambda: lp_mod.ctc_grad_plain(em, alpha, accept, skip, il, score, g),
        runs=20)

    # F.ctc_loss copies its length tensors to the host; lengths already on
    # the host keep that copy from synchronising the device on every call
    lp_tbc = lp.transpose(0, 1)
    il_host, tl_host = il.cpu(), tl.cpu()
    t["f_ctc_loss_fwd"] = gpu_median_ms(torch, lambda: F.ctc_loss(
        lp_tbc, targets, il_host, tl_host, blank=BLANK, reduction="mean"))
    lp_req = lp.detach().clone().requires_grad_(True)

    def f_ctc_fwd_bwd():
        loss = F.ctc_loss(lp_req.transpose(0, 1), targets, il_host, tl_host,
                          blank=BLANK, reduction="mean")
        torch.autograd.grad(loss, lp_req)

    t["f_ctc_loss_fwd_bwd"] = gpu_median_ms(torch, f_ctc_fwd_bwd)
    t["port_ctc_loss_fwd"] = gpu_median_ms(torch, lambda: lattice.ctc_loss(
        lp, targets, tl, BLANK, "mean", il))

    def port_fwd_bwd():
        loss = lattice.ctc_loss(lp_req, targets, tl, BLANK, "mean", il)
        torch.autograd.grad(loss, lp_req)

    t["port_ctc_loss_fwd_bwd"] = gpu_median_ms(torch, port_fwd_bwd)

    # the backtrace at the ASG headline
    bp, last = asg_headline_inputs(torch, dev)
    t["dense_bt"] = gpu_median_ms(torch, lambda: vsp.dense_backtrace_cuda(bp, last))
    t["dense_bt_plain"] = gpu_median_ms(
        torch, lambda: vsp.dense_backtrace_plain(bp, last), runs=20)

    # the dense scan at the STC headline, and at S = 304
    scans = {}
    for key, shape in (("", (B, T, STC_L)), ("_s304", WIDE_STC)):
        em_s, adj, st, lab, acc, sil = stc_headline_inputs(torch, dev, *shape)
        traj = dsp.dense_scan_fwd_cuda(em_s, adj, st, lab, sil)
        gf = score_cotangent(torch, traj[:, -1], acc)
        scans[key] = (em_s.shape[2], sil)
        t["dense_scan_fwd" + key] = gpu_median_ms(
            torch, lambda: dsp.dense_scan_fwd_cuda(em_s, adj, st, lab, sil))
        t["dense_scan_bwd" + key] = gpu_median_ms(
            torch, lambda: dsp.dense_scan_bwd_cuda(traj, adj, st, lab, sil, gf))
        if key == "":
            t["dense_scan_fwd_plain"] = gpu_median_ms(
                torch, lambda: dsp.dense_scan_fwd_plain(em_s, adj, st, lab, sil),
                runs=20)
            t["dense_scan_bwd_plain"] = gpu_median_ms(
                torch, lambda: dsp.dense_scan_bwd_plain(traj, adj, st, lab, sil, gf),
                runs=20)
            t["dense_scan_bwd_no_dadj"] = gpu_median_ms(
                torch, lambda: dsp.dense_scan_bwd_cuda(traj, adj, st, lab, sil, gf,
                                                       need_dadj=False))
    S_stc, stc_il = scans[""]

    # one full train step of each path at its main path's shape
    for path, info in paths.items():
        t[f"train_step_{path}"], t[f"train_step_{path}_shape"] = time_train_step(
            torch, dev, info["model"], main_path_config(path))

    # one frame of the recursion's dependent chain: the probe's time for
    # 2n frames less its time for n, over n (the launch cancels)
    lib = _build.load_library("ctc")
    pem = lp[0, 0, torch.arange(96, device=dev) % N].contiguous()
    pout = torch.empty_like(pem)
    stream = _build.stream_handle(pem)

    def run_probe(frames):
        err = lib.ctc_chain_probe(pem.data_ptr(), pout.data_ptr(), frames, stream)
        _build.check(lib, err, "ctc_chain_probe")

    n = 4096
    t_n = gpu_median_ms(torch, lambda: run_probe(n), runs=20)
    t_2n = gpu_median_ms(torch, lambda: run_probe(2 * n), runs=20)
    t["chain_frame_us"] = (t_2n - t_n) / n * 1e3

    # bounds from this run's inputs: live frames only where the kernel
    # skips the frozen tail
    live_states = int(il.clamp(max=T).sum()) * S
    state_bytes = B * S * 4
    stc_live = int(stc_il.clamp(min=1).sum()) * S_stc
    stc_vec = B * S_stc * 4
    stc_adj = B * S_stc * S_stc * 4
    bounds = {
        "gather_fwd": bound_ms(lp.numel() * 4 + labels.numel() * 4 + B * T * S * 4, 0),
        "gather_bwd": bound_ms(grad.numel() * 4 + labels.numel() * 4 + lp.numel() * 4,
                               grad.numel()),
        "ctc_alpha": bound_ms(live_states * 4 + 2 * state_bytes + B * 4 + B * T * S * 4,
                              (live_states - B * S) * ALPHA_OPS),
        "ctc_grad": bound_ms(2 * live_states * 4 + 2 * state_bytes + 3 * B * 4
                             + B * T * S * 4, live_states * GRAD_OPS),
        # the walk reads one entry of each of a sample's T-1 frames, a
        # scattered load that moves at least one 32-byte sector; last read
        # and the path written once; no arithmetic
        "dense_bt": bound_ms(bp.shape[0] * bp.shape[1] * 32 + last.numel() * 4
                             + B * T * 4, 0),
        # em (live frames), adj, start, has_lab, lengths in; traj out; per
        # frame a 2 S^2 matvec plus max, sub, exp, log, floor, adds, masks
        "dense_scan_fwd": bound_ms(
            stc_live * 4 + stc_adj + 2 * stc_vec + B * 4 + B * T * S_stc * 4,
            scan_work(stc_il, S_stc, DENSE_FWD_OPS, 2)),
        # traj (live frames), adj, start, has_lab, g, lengths in; dem, dadj
        # out; per frame three S^2 products (z, adj^T dz, dz e^T)
        "dense_scan_bwd": bound_ms(
            stc_live * 4 + 2 * stc_adj + 3 * stc_vec + B * 4 + B * T * S_stc * 4,
            scan_work(stc_il, S_stc, DENSE_BWD_OPS, 6)),
    }
    # both recursions take max(len) - 1 dependent frames (the forward from
    # frame 1, the backward down to frame 1); no design with this
    # arithmetic can take less
    chain = {name: (int(il.max()) - 1) * t["chain_frame_us"] * 1e-3
             for name in ("ctc_alpha", "ctc_grad")}
    t["shape"] = {"B": B, "T": T, "L": L, "N": N, "S": S,
                  "asg_C": ASG_C, "stc_L": STC_L, "stc_S": S_stc}
    return t, bounds, chain


KERNELS = [
    ("gather_fwd", "gtn_applications_tpu_torch/ops/csrc/gather.cu",
     "gtn_applications_tpu/ops/gathers.py:30", "f_ctc_loss_fwd"),
    ("gather_bwd", "gtn_applications_tpu_torch/ops/csrc/gather.cu",
     "gtn_applications_tpu/ops/gathers.py:44", "f_ctc_loss_fwd_bwd"),
    ("ctc_alpha", "gtn_applications_tpu_torch/ops/csrc/ctc.cu",
     "gtn_applications_tpu/ops/lattice_pallas.py:57", "f_ctc_loss_fwd"),
    ("ctc_grad", "gtn_applications_tpu_torch/ops/csrc/ctc.cu",
     "gtn_applications_tpu/ops/lattice_pallas.py:79", "f_ctc_loss_fwd_bwd"),
    ("dense_bt", "gtn_applications_tpu_torch/ops/csrc/viterbi.cu",
     "gtn_applications_tpu/ops/viterbi_scan_pallas.py:239", None),
    ("dense_scan_fwd", "gtn_applications_tpu_torch/ops/csrc/dense_scan.cu",
     "gtn_applications_tpu/ops/dense_scan_pallas.py:90", None),
    ("dense_scan_bwd", "gtn_applications_tpu_torch/ops/csrc/dense_scan.cu",
     "gtn_applications_tpu/ops/dense_scan_pallas.py:119", None),
]


def run():
    import torch

    import gtn_applications_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_device(torch)
    dev = torch.device("cuda")
    build_s = phase_build()
    errs = phase_gather(torch, dev)
    errs.update(phase_ctc(torch, dev))
    merge_errs(errs, phase_dense_bt(torch, dev))
    merge_errs(errs, phase_dense_scan(torch, dev))
    paths = {path: phase_main_path(torch, dev, path, main_path_config(path))
             for path in PATHS}
    diffs = {}
    for path, check in (("ctc", phase_main_batch), ("asg", phase_main_batch_asg),
                        ("stc", phase_main_batch_stc)):
        main_errs, more = check(torch, dev, paths[path]["model"], main_path_config(path))
        merge_errs(errs, main_errs)
        diffs.update(more)
    times, bounds, chain = phase_times(torch, dev, paths)

    launches = {name: sum(p["launches"][name] for p in paths.values())
                for name, *_ in KERNELS}
    timing = dict(times, card=card, build_s=build_s, **diffs,
                  f_ctc_loss_abs_diff=errs["f_ctc_loss_abs_diff"],
                  f_ctc_grad_max_abs_diff=errs["f_ctc_grad_max_abs_diff"])
    for path, info in paths.items():
        timing[f"main_path_{path}_s"] = info["seconds"]
        timing[f"main_path_{path}_launches"] = info["launches"]
        timing[f"main_path_{path}_steps"] = info["steps"]
        timing[f"main_path_{path}_eval_batches"] = info["evals"]
        timing[f"main_path_{path}_test"] = info["test"]
    kernels = []
    for name, source, replaces, library in KERNELS:
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name],
            "plain_ms": times[f"{name}_plain"], "bound_ms": b_ms,
            "bound_by": b_by, "chain_bound_ms": chain.get(name),
            "library_ms": times[library] if library else None,
        })
        # dadj's entries reach 1e38, so its absolute error says little: the
        # entrywise error of hold_dense_scan_kernels is the one checked
        if f"{name}_rel" in errs:
            kernels[-1]["max_rel_err"] = errs[f"{name}_rel"]
    print(json.dumps({"timing": timing}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main():
    try:
        run()
    except Exception:  # report which phase failed, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
