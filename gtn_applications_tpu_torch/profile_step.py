"""Where one train step of a main path spends its device time.

    python -m gtn_applications_tpu_torch.profile_step [--steps 10] \
        [--config configs/iamdb/tds2d_asg.json | tds2d_stc.json | ngram_ctc.json
                  | pruned_ngram_ctc.json | word_decomps.json | ...] [--prune 0 5 10] \
        [--tokens FILE]

Builds the model and criterion of the config (configs/iamdb/tds2d.json, the
CTC path, by default) with random weights from a seed, takes one batch of
the config's batch size (the split's lines again where it holds fewer):
synthetic 64-row lines, the long-line corpus for a TDS2d at a time stride
of 16 (pruned_ngram_ctc.json's, word_decomps.json's) or for a config that
loads a transition graph, synthetic tones for a speech config; with the
config's ``prepend_wordsep`` and token and lexicon files (the token file
``--tokens`` where the config's own is absent, e.g. the 1,000 pieces that
``chip_smoke.wordpiece_inventories`` writes), warms up, then
runs ``--steps`` train steps under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON object: the host-clock median step time, the
device-busy share of the profiled window (kernel time over wall time), and
the operators and kernels that took the most device time.  Needs a GPU.
Where the config's transition graph file is absent (the IAM recipe's
``<replace_me>`` paths), the grapheme LM of ``--prune``'s count thresholds
(one per order; default the recipe's trigram, ``0 5 10``; ``0 0 0 0`` is
the smoke's unpruned 4-gram) is built over the corpus into
``build/profile_step`` and loaded instead.
"""

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from . import train as train_mod
from . import utils
from .datasets import synthetic, synthetic_audio, synthetic_long

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "iamdb" / "tds2d.json"


def long_corpus_lm(path, prune):
    """Write the grapheme LM of the recipe's builder (optional blank) over
    the long-line train split's texts to ``path``: one order per entry of
    ``prune``, those count thresholds.  Returns ``path``."""
    from .scripts.build_transitions import grapheme_lm
    from .wfst import graph as wgraph

    pre = synthetic_long.Preprocessor(None, num_features=64)
    texts = synthetic_long.Dataset(None, pre, split="train").texts
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    wgraph.save(path, grapheme_lm(texts, pre.tokens, prune))
    return path


SPEECH = ("librispeech", "wsj", "audioset")


def _time_stride(config):
    """The time stride of a TDS2d config's groups (1 for other models)."""
    stride = 1
    for group in config["model"].get("tds_groups", []):
        stride *= group.get("stride", [1, 1])[1]
    return stride if config["model_type"] == "tds2d" else 1


def _data_and_criterion(config, prune=(0, 5, 10)):
    """(dataset module, criterion config): synthetic tones for a speech
    config; the long-line corpus for a time stride of 16 and, where the
    config's transition graph file is absent, the grapheme LM of
    ``prune`` built over that corpus."""
    crit_cfg = dict(config.get("criterion", {}))
    if "transitions" not in crit_cfg:
        if config["data"]["dataset"] in SPEECH:
            return synthetic_audio, crit_cfg
        return (synthetic_long if _time_stride(config) >= 16 else synthetic), crit_cfg
    if not Path(crit_cfg["transitions"]).exists():
        name = "_".join(str(p) for p in prune)
        crit_cfg["transitions"] = str(long_corpus_lm(
            ROOT / "build" / "profile_step" / f"transitions_{name}.bin", prune))
    return synthetic_long, crit_cfg


def _self_device_us(evt):
    # the attribute's name changed across PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _file(config, key, given=None):
    """``given``, else the config's data file ``key`` where it exists."""
    path = given or config["data"].get(key)
    return path if path and Path(path).exists() else None


def profile(steps=10, top=12, seed=0, config_path=CONFIG, prune=(0, 5, 10), tokens=None):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    device = train_mod.select_device()
    with open(config_path) as fid:
        config = json.load(fid)
    data, crit_cfg = _data_and_criterion(config, tuple(prune))
    pre = data.Preprocessor(None, num_features=config["data"]["num_features"],
                            tokens_path=_file(config, "tokens", tokens),
                            lexicon_path=_file(config, "lexicon"),
                            prepend_wordsep=config["data"].get("prepend_wordsep", False))
    ds = data.Dataset(None, pre, split="train")
    batch = config["optim"]["batch_size"]
    inputs, _, targets = utils.padding_collate([ds[i % len(ds)] for i in range(batch)])
    crit, n_out = utils.load_criterion(
        config.get("criterion_type", "ctc"), pre, crit_cfg)
    train_mod.criterion_to_device(crit, device)
    gen = torch.Generator().manual_seed(seed)
    model = utils.load_model(
        config["model_type"], pre.num_features, n_out, config["model"],
        generator=gen,
    ).to(device)
    optim = config["optim"]
    step = train_mod.make_train_step(
        model, crit, optim["learning_rate"],
        optim.get("crit_learning_rate", optim["learning_rate"]),
        optim["max_grad_norm"],
    )
    x = torch.from_numpy(inputs).to(device)
    prepared = train_mod.to_device(crit.prepare(targets), device)
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
        "criterion": config.get("criterion_type", "ctc"),
        "dataset": data.__name__.rsplit(".", 1)[-1],
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
    parser.add_argument("--config", type=str, default=str(CONFIG))
    parser.add_argument("--prune", type=int, nargs="+", default=[0, 5, 10],
                        help="count thresholds of the grapheme LM built where the "
                             "config's transition graph file is absent")
    parser.add_argument("--tokens", help="token file where the config's is absent")
    args = parser.parse_args(argv)
    print(json.dumps(profile(args.steps, config_path=args.config, prune=args.prune,
                             tokens=args.tokens)))


if __name__ == "__main__":
    main()
