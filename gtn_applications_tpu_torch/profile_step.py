"""Where one train step of the main path spends its device time.

    python -m gtn_applications_tpu_torch.profile_step [--steps 10]

Builds the TDS2d model of configs/iamdb/tds2d.json with random weights
from a seed, takes one batch of 32 synthetic 64-row lines, warms up, then
runs ``--steps`` train steps under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON object: the host-clock median step time, the
device-busy share of the profiled window (kernel time over wall time), and
the operators and kernels that took the most device time.  Needs a GPU.
"""

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from . import train as train_mod
from . import utils
from .criterions import CTC
from .datasets import synthetic

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "iamdb" / "tds2d.json"


def _self_device_us(evt):
    # the attribute's name changed across PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile(steps=10, top=12, seed=0):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    device = train_mod.select_device()
    with open(CONFIG) as fid:
        config = json.load(fid)
    pre = synthetic.Preprocessor(None, num_features=config["data"]["num_features"])
    ds = synthetic.Dataset(None, pre, split="train")
    batch = config["optim"]["batch_size"]
    inputs, _, targets = utils.padding_collate([ds[i] for i in range(batch)])
    crit = CTC(pre.num_tokens)
    gen = torch.Generator().manual_seed(seed)
    model = utils.load_model(
        config["model_type"], pre.num_features, pre.num_tokens + 1,
        config["model"], generator=gen,
    ).to(device)
    optim = config["optim"]
    step = train_mod.make_train_step(
        model, crit, optim["learning_rate"], optim["learning_rate"],
        optim["max_grad_norm"],
    )
    x = torch.from_numpy(inputs).to(device)
    prepared = tuple(p.to(device) for p in crit.prepare(targets))
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    def run_step():
        step(x, prepared, dropout_gen, 1.0)

    for _ in range(5):
        run_step()
    torch.cuda.synchronize()
    host_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernel_us = sum(_self_device_us(e) for e in kernels)
    ops = [e for e in events if e not in kernels and _self_device_us(e) > 0]

    def rows(evts):
        ranked = sorted(evts, key=lambda e: -_self_device_us(e))[:top]
        return [
            {"name": e.key[:90], "calls": e.count,
             "device_ms_per_step": _self_device_us(e) / 1e3 / steps}
            for e in ranked
        ]

    return {
        "card": utils.card_name_and_power_limit(),
        "input_shape": list(inputs.shape),
        "steps": steps,
        "host_step_ms_median": statistics.median(host_ms),
        "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
        "kernel_ms_per_step": kernel_us / 1e3 / steps,
        "device_busy_share": kernel_us / wall_us if wall_us else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_ops_self_device": rows(ops),
        "top_kernels": rows(kernels),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)
    print(json.dumps(profile(args.steps)))


if __name__ == "__main__":
    main()
