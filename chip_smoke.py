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
5. main path: ``train.train`` of the port for 2 epochs (64 synthetic
   samples, batch 32: 4 steps plus validation) with the model section of
   configs/iamdb/tds2d.json unchanged, then ``test.run_test`` on the
   checkpoint; the launch counters are zeroed just before and read just
   after, and every kernel must have launched at least once per train step;
   then, on the trainer's first batch and the trained model: the logits on
   the card against the same model on the CPU (plain versions) within
   1e-3, the CTC loss and its logit gradient on the card against the CPU
   on the same logits within 1e-4 and 1e-6, and the four kernels against
   their plain versions on the inputs the train step gives them, at the
   tolerances of phases 3-4;
6. times: CUDA-event medians of 30 runs after warm-up at the phase-4 shape
   for each kernel, its plain version and F.ctc_loss, the host-clock
   median of 20 full train steps at the phase-5 shape, and the latency of
   one frame of the CTC recursion's dependent chain (``ctc_chain_probe``)
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


def main_path_config():
    with open(ROOT / "configs" / "iamdb" / "tds2d.json") as fid:
        base = json.load(fid)
    optim = dict(base["optim"], epochs=2)
    return {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 64},
        "model_type": base["model_type"],
        "model": base["model"],
        "criterion_type": "ctc",
        "optim": optim,
    }


def phase_main_path(torch, dev, config):
    from gtn_applications_tpu_torch import test as test_mod
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch.ops import _build

    WORK.mkdir(parents=True, exist_ok=True)
    cfg = WORK / "config.json"
    cfg.write_text(json.dumps(config))
    args = train_mod.parse_args(["--config", str(cfg), "--checkpoint_path", str(WORK)])
    targs = test_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(WORK), "--split", "test"]
    )

    _build.reset_launches()
    t0 = time.perf_counter()
    model, history = train_mod.train(args)
    meters = test_mod.run_test(targs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    # the synthetic train split holds 64 samples
    steps = config["optim"]["epochs"] * (64 // config["optim"]["batch_size"])
    for h in history:
        for key in ("train_loss", "val_loss", "val_cer", "val_wer"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"epoch {h['epoch']}: {key} = {h[key]}")
    if not (meters.num_samples == 16 and meters.num_tokens > 0
            and math.isfinite(meters.avg_loss)):
        raise AssertionError(f"test split: {meters}")
    for name, n in launches.items():
        if n < steps:
            raise AssertionError(f"kernel {name} launched {n} < {steps} times")
    log(f"main path: {seconds:.1f} s, history {json.dumps(history)}, "
        f"test loss {meters.avg_loss:.4f} CER {meters.cer:.2f} WER {meters.wer:.2f}, "
        f"launches {json.dumps(launches)}")
    return model, launches, history, meters, seconds


def phase_main_batch(torch, dev, model, config):
    """The trainer's first batch through the trained model: the encoder on
    the card against the CPU, the CTC loss and logit gradient on the card
    against the CPU on the same logits, and the four kernels against their
    plain versions on the inputs the train step gives them (no input
    lengths, as the config sets none: every frame is live)."""
    import copy

    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.criterions import CTC
    from gtn_applications_tpu_torch.datasets import synthetic

    pre = synthetic.Preprocessor(None, num_features=config["data"]["num_features"])
    trainset = synthetic.Dataset(None, pre, split="train", augment=True)
    loader = utils.data_loader(trainset, config, seed=config["seed"])
    inputs, _, targets = next(iter(loader))
    crit = CTC(pre.num_tokens)
    prepared = crit.prepare(targets)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs).to(dev))
        d_out = float((logits.cpu() - cpu_model(torch.from_numpy(inputs))).abs().max())

    def loss_and_grad(x, prep):
        x = x.detach().clone().requires_grad_(True)
        loss = crit.loss({}, x, prep)
        return float(loss.detach()), torch.autograd.grad(loss, x)[0]

    loss_g, grad_g = loss_and_grad(logits, tuple(p.to(dev) for p in prepared))
    loss_c, grad_c = loss_and_grad(logits.cpu(), prepared)
    d_loss = abs(loss_g - loss_c)
    d_grad = float((grad_g.cpu() - grad_c).abs().max())
    log(f"main batch {list(logits.shape)}: card vs cpu logits max|d| {d_out:.3g}, "
        f"loss {loss_g:.6f} |d| {d_loss:.3g}, logit grad max|d| {d_grad:.3g}")
    if not (d_out <= 1e-3 and d_loss <= 1e-4 and d_grad <= 1e-6):
        raise AssertionError("the card and the CPU disagree on the main batch")

    tgts, tl = (p.to(dev) for p in prepared)
    lp, labels, em, start, accept, skip = ctc_kernel_inputs(
        torch, logits, tgts, tl, crit.blank)
    bsz, frames = logits.shape[:2]
    il = torch.full((bsz,), frames, dtype=torch.int32, device=dev)
    g = -1.0 / (bsz * tl.to(torch.float32).clamp(min=1))
    what = (bsz, frames, tgts.shape[1], logits.shape[2])
    errs, grad = hold_ctc_kernels(torch, em, start, accept, skip, il, g, what)
    merge_errs(errs, hold_gather_kernels(torch, lp, labels, grad, what))
    return errs, {"card_vs_cpu_logits_max_abs_diff": d_out,
                  "card_vs_cpu_loss_abs_diff": d_loss,
                  "card_vs_cpu_logit_grad_max_abs_diff": d_grad,
                  "main_batch_shape": list(what)}


def phase_times(torch, dev, model, config):
    from gtn_applications_tpu_torch import train as train_mod
    from gtn_applications_tpu_torch import utils
    from gtn_applications_tpu_torch.criterions import CTC
    from gtn_applications_tpu_torch.datasets import synthetic
    from gtn_applications_tpu_torch.ops import _build, gathers, lattice
    from gtn_applications_tpu_torch.ops import lattice_pallas as lp_mod

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

    # one full train step at the main path's shape (host clock, synced)
    pre = synthetic.Preprocessor(None, num_features=config["data"]["num_features"])
    ds = synthetic.Dataset(None, pre, split="train")
    batch = config["optim"]["batch_size"]
    inputs, _, tgts = utils.padding_collate([ds[i] for i in range(batch)])
    crit = CTC(pre.num_tokens)
    prepared = tuple(p.to(dev) for p in crit.prepare(tgts))
    x = torch.from_numpy(inputs).to(dev)
    optim = config["optim"]
    step = train_mod.make_train_step(
        model, crit, optim["learning_rate"], optim["learning_rate"],
        optim["max_grad_norm"],
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, prepared, gen, 1.0)
        torch.cuda.synchronize()
        if i >= 5:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    t["train_step"] = statistics.median(step_ms)
    t["train_step_shape"] = list(inputs.shape)

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
    bounds = {
        "gather_fwd": bound_ms(lp.numel() * 4 + labels.numel() * 4 + B * T * S * 4, 0),
        "gather_bwd": bound_ms(grad.numel() * 4 + labels.numel() * 4 + lp.numel() * 4,
                               grad.numel()),
        "ctc_alpha": bound_ms(live_states * 4 + 2 * state_bytes + B * 4 + B * T * S * 4,
                              (live_states - B * S) * ALPHA_OPS),
        "ctc_grad": bound_ms(2 * live_states * 4 + 2 * state_bytes + 3 * B * 4
                             + B * T * S * 4, live_states * GRAD_OPS),
    }
    # both recursions take max(len) - 1 dependent frames (the forward from
    # frame 1, the backward down to frame 1); no design with this
    # arithmetic can take less
    chain = {name: (int(il.max()) - 1) * t["chain_frame_us"] * 1e-3
             for name in ("ctc_alpha", "ctc_grad")}
    t["shape"] = {"B": B, "T": T, "L": L, "N": N, "S": S}
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
]


def run():
    import torch

    import gtn_applications_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_device(torch)
    dev = torch.device("cuda")
    build_s = phase_build()
    errs = phase_gather(torch, dev)
    errs.update(phase_ctc(torch, dev))
    config = main_path_config()
    model, launches, history, meters, main_s = phase_main_path(torch, dev, config)
    main_errs, card_vs_cpu = phase_main_batch(torch, dev, model, config)
    merge_errs(errs, main_errs)
    times, bounds, chain = phase_times(torch, dev, model, config)

    timing = dict(times, card=card, build_s=build_s, main_path_s=main_s,
                  **card_vs_cpu,
                  f_ctc_loss_abs_diff=errs["f_ctc_loss_abs_diff"],
                  f_ctc_grad_max_abs_diff=errs["f_ctc_grad_max_abs_diff"])
    kernels = []
    for name, source, replaces, library in KERNELS:
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name],
            "plain_ms": times[f"{name}_plain"], "bound_ms": b_ms,
            "bound_by": b_by, "chain_bound_ms": chain.get(name),
            "library_ms": times[library],
        })
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
