"""Multi-process dry run: one train step of each criterion family over n ranks.

Twin of ``__graft_entry__.dryrun_multichip(n)`` of the JAX package: it
spawns ``n`` ranks (the ``spawn`` start method, a gloo or NCCL process
group) and each rank runs one train step of every leg on its rows of a
global batch made from a seed, the gradient reduced over the ranks
(``train.make_train_step``):

  * ``ctc``: TDS2d (the flagship's widths, one block a group) with CTC on
    [2n, 64, 64] inputs;
  * ``asg``, ``stc``, ``transducer_ngram`` (bigram, optional blank),
    ``transducer_plain`` (transitions-free, two-grapheme pieces) on a small
    dense encoder over [2n, 12, 8] features;
  * ``tds2d_transducer``: ``TDS2dTransducer`` (the WFST convolution) with
    CTC on [2n, 8, 32];
  * ``transducer_backoff``: a Transducer composed with a loaded backoff
    bigram built by ``scripts.build_transitions`` (JAX's dryrun has no such
    leg);
  * ``seq_ctc``: the sequence-parallel assoc CTC (``ops.lattice
    .ctc_forward_score_assoc`` with a ``'seq'`` group, chunk 128) on a
    ``d x n/d`` grid with ``'seq'`` >= 2 (d = 2 where n is even and above
    2), [2d, 512, 6] log-probabilities, its loss the sum of the scores and
    its gradient to each rank's frames.

Each leg prints ``dryrun_multichip(n): <leg> loss=... ok``.  With
``check``, the parent also runs each leg as one process on the global batch
and holds the ranks' loss to it within ``LOSS_RTOL``, each rank's
parameters after the step within ``GRAD_TOL`` (and the seq leg's
gradient, reassembled from the ranks, within ``GRAD_TOL``).  It runs on
CUDA unless ``--device cpu`` asks for the CPU:

    python -m gtn_applications_tpu_torch.dryrun --n 2
        # on one card: gloo ranks sharing cuda:0 (NCCL refuses two ranks
        # on one device); one rank a card with --backend nccl
    python -m gtn_applications_tpu_torch.dryrun --n 4 --device cpu  # gloo
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.nn as nn

from .parallel import mesh as pmesh

LEGS = ("ctc", "asg", "stc", "transducer_ngram", "transducer_plain",
        "tds2d_transducer", "transducer_backoff")
SEQ_LEG = "seq_ctc"
# the small legs' classes, frames and features, as JAX's dryrun
C, T, F = 5, 12, 8
# the seq leg: frames, channels (blank last), chunk, target length
SEQ_T, SEQ_C, SEQ_CHUNK, SEQ_L = 512, 6, 128, 4
LR, MAX_GRAD_NORM = 0.01, 5.0
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the WFST convolution's pieces (JAX's dryrun's file)
TDS2D_TRANSDUCER_TOKENS = "ab\nba\na\nb\n"
TINY_TDS = {"depth": 2, "tds_groups": [{"channels": 2, "num_blocks": 1, "stride": [2, 2]}],
            "kernel_size": [3, 3], "dropout": 0.0}


class TinyEncoder(nn.Module):
    """JAX's dryrun encoder: Dense(32), relu, Dense(output_size) over the
    feature axis ([B, T, F] -> [B, T, output_size]); normal kernels of
    variance 1 / fan-in and zero biases, drawn from ``generator``."""

    def __init__(self, input_size, output_size, hidden=32, generator=None):
        super().__init__()
        self.dense0 = nn.Linear(input_size, hidden)
        self.dense1 = nn.Linear(hidden, output_size)
        with torch.no_grad():
            for layer in (self.dense0, self.dense1):
                fan_in = layer.weight.shape[1]
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                   / np.sqrt(fan_in))
                layer.bias.zero_()

    def forward(self, inputs, train=False, generator=None):
        return self.dense1(torch.relu(self.dense0(inputs)))


def flagship(generator=None):
    """JAX's dryrun flagship: TDS2d over 64 features, 80 outputs, four
    groups of one block (4, 16, 32 and 64 channels), kernel 5 x 7; CTC with
    blank 79."""
    from .criterions import CTC
    from .models import TDS2d

    model = TDS2d(
        input_size=64, output_size=80, depth=4,
        tds_groups=[
            {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
            {"channels": 16, "num_blocks": 1, "stride": [2, 2]},
            {"channels": 32, "num_blocks": 1, "stride": [2, 1]},
            {"channels": 64, "num_blocks": 1, "stride": [2, 1]},
        ],
        kernel_size=[5, 7], dropout=0.0, generator=generator,
    )
    return model, CTC(blank=79)


def backoff_transitions(num_classes=C, seed=8):
    """A pruned backoff bigram with optional blanks over ``num_classes``
    tokens, built by ``scripts.build_transitions`` from 150 seeded lines;
    (graph, lines)."""
    from .scripts import build_transitions

    rng = np.random.RandomState(seed)
    lines = [[str(i) for i in rng.randint(0, num_classes, rng.randint(3, 9))]
             for _ in range(150)]
    graph = build_transitions.build_from_lines(
        lines, [str(i) for i in range(num_classes)], [0, 1], "optional")
    return graph, lines


def criterion_suite(name, num_classes=C):
    """(criterion, model output size) of a small leg, as JAX's dryrun's
    ``_criterion_suite`` (and the backoff leg)."""
    from .criterions import ASG, STC, Transducer

    tokens = [(i,) for i in range(num_classes)]
    g2i = {i: i for i in range(num_classes)}
    if name == "asg":
        return ASG(num_classes, num_replabels=1, use_garbage=True), num_classes + 2
    if name == "stc":
        return STC(blank_idx=0, reduction="mean", shift_targets=1), num_classes + 1
    if name == "transducer_ngram":
        return (Transducer(tokens, g2i, ngram=2, blank="optional", reduction="mean"),
                num_classes + 1)
    if name == "transducer_plain":
        return (Transducer(tokens + [(0, 1), (1, 2)], g2i, blank="optional",
                           allow_repeats=False, reduction="mean"),
                num_classes + 2 + 1)
    if name == "transducer_backoff":
        graph, _ = backoff_transitions(num_classes)
        return (Transducer([str(i) for i in range(num_classes)],
                           {str(i): i for i in range(num_classes)},
                           transitions=graph, blank="optional", reduction="mean"),
                num_classes + 1)
    raise ValueError(f"unknown leg {name}")


def leg_data(name, n, seed=0):
    """The global batch of a leg over ``n`` ranks: (inputs [2n, ...] float32
    numpy, targets list, time axis of the inputs), from its own seeded
    stream."""
    rng = np.random.RandomState(seed + LEGS.index(name))
    B = 2 * n
    if name == "ctc":
        x = rng.randn(B, 64, 64).astype(np.float32)
        return x, [list(rng.randint(0, 79, size=5)) for _ in range(B)], 2
    if name == "tds2d_transducer":
        x = rng.randn(B, 8, 32).astype(np.float32)
        return x, [list(rng.randint(0, 5, size=2)) for _ in range(B)], 2
    x = rng.randn(B, T, F).astype(np.float32)
    return x, [list(rng.randint(0, C, size=3)) for _ in range(B)], 1


def build_leg(name, workdir, seed=0):
    """(model, criterion) of a leg, the model's parameters drawn from
    ``seed``; ``workdir`` holds the WFST convolution's pieces file."""
    from .criterions import CTC
    from .models import TDS2dTransducer

    gen = torch.Generator().manual_seed(seed)
    if name == "ctc":
        return flagship(gen)
    if name == "tds2d_transducer":
        tokens = os.path.join(workdir, "dryrun_tokens.txt")
        with open(tokens, "w") as fid:
            fid.write(TDS2D_TRANSDUCER_TOKENS)
        model = TDS2dTransducer(
            input_size=8, output_size=6, tokens=tokens, kernel_size=5, stride=2,
            tds1=dict(TINY_TDS),
            tds2={**TINY_TDS, "tds_groups": [{"channels": 2, "num_blocks": 1,
                                               "stride": [1, 1]}]},
            wfst=True, generator=gen,
        )
        return model, CTC(blank=5)
    crit, out_size = criterion_suite(name)
    return TinyEncoder(F, out_size, generator=gen), crit


def seq_grid(n):
    """(d, n / d): the seq leg's ``('data', 'seq')`` grid, 'seq' >= 2."""
    d = 2 if n % 2 == 0 and n > 2 else 1
    return d, n // d


def seq_data(n, seed=0):
    """The seq leg's global log-probabilities [2d, 512, 6] (float32), targets
    [2d, 4] over the non-blank channels and their lengths."""
    d, _ = seq_grid(n)
    rng = np.random.RandomState(seed + len(LEGS))
    x = torch.from_numpy(rng.randn(2 * d, SEQ_T, SEQ_C).astype(np.float32))
    lp = torch.log_softmax(x, dim=2)
    targets = rng.randint(0, SEQ_C - 1, size=(2 * d, SEQ_L))
    return lp.numpy(), targets, np.full((2 * d,), SEQ_L)


def _state(model, crit):
    """The leg's parameters as numpy: the model's ``state_dict`` and the
    criterion's parameters under ``criterion.``."""
    out = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    out.update({f"criterion.{k}": v.detach().cpu().numpy()
                for k, v in crit.params.items()})
    return out


def _load_state(model, crit, state, device):
    from .train import criterion_to_device

    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()
                           if not k.startswith("criterion.")})
    model.to(device)
    params = {k[len("criterion."):]: torch.from_numpy(np.asarray(v))
              for k, v in state.items() if k.startswith("criterion.")}
    criterion_to_device(crit, device, params or None)


def leg_step(name, n, device, mesh=None, weights=None, workdir=None, seed=0):
    """One train step of leg ``name`` on this rank's rows of its global
    batch (all rows without a ``mesh``).  Returns {"loss": the global
    batch's loss, "params": the parameters after the step}."""
    from .train import make_train_step, to_device

    workdir = workdir or tempfile.gettempdir()
    model, crit = build_leg(name, workdir, seed)
    _load_state(model, crit, weights if weights is not None else _state(model, crit),
                device)
    x, targets, _ = leg_data(name, n, seed)
    rows = np.arange(len(targets))
    group = None
    if mesh is not None:
        x = pmesh.shard_batch(x, mesh)
        rows = pmesh.shard_batch(rows, mesh).numpy()
        group = mesh.group("data")
    prepared = to_device(crit.prepare([targets[i] for i in rows]), device)
    step = make_train_step(model, crit, LR, LR, MAX_GRAD_NORM, group)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    loss, _ = step(torch.as_tensor(x).to(device), prepared, gen, 1.0)
    return {"loss": float(loss), "params": _state(model, crit)}


def seq_step(n, device, mesh=None, seed=0):
    """The seq leg: the sum over the global batch of the assoc CTC scores
    (chunk 128) and its gradient to the log-probabilities, this rank's rows
    and frames on a ``('data', 'seq')`` mesh (all of them without one).
    Returns {"loss", "grad" (this rank's block), "rows", "frames"}."""
    import torch.distributed as dist

    from .ops import lattice

    lp, targets, lens = seq_data(n, seed)
    rows, frames = np.arange(lp.shape[0]), np.arange(SEQ_T)
    lp = torch.from_numpy(lp)
    seq_group = data_group = None
    if mesh is not None:
        lp = pmesh.shard_batch_time(lp, mesh, 1)
        rows = pmesh.shard_batch(rows, mesh).numpy()
        frames = frames.reshape(mesh.dim("seq"), -1)[mesh.coord("seq")]
        seq_group, data_group = mesh.group("seq"), mesh.group("data")
    lp = lp.to(device).clone().requires_grad_(True)
    score = lattice.ctc_forward_score_assoc(
        lp, torch.from_numpy(targets[rows]), torch.from_numpy(lens[rows]), SEQ_C - 1,
        chunk=SEQ_CHUNK, seq_group=seq_group).sum()
    score.backward()
    total = score.detach()
    if data_group is not None and dist.get_world_size(data_group) > 1:
        total = pmesh.all_reduce(total, data_group)
    return {"loss": float(total), "grad": lp.grad.cpu().numpy(), "rows": rows,
            "frames": frames}


def rank_main(rank, n, device, legs=LEGS + (SEQ_LEG,), weights=None, seed=0):
    """A rank's dry run: every leg of ``legs`` on its rows, then the seq
    leg on the ``d x n/d`` grid; returns {leg: leg_step's or seq_step's
    result} and this rank's kernel launches under "launches"."""
    from .ops import _build

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launches()
    mesh = pmesh.make_mesh()
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        for name in legs:
            if name == SEQ_LEG:
                out[name] = seq_step(n, device, pmesh.make_mesh(seq_grid(n)[1]), seed)
            else:
                out[name] = leg_step(name, n, device, mesh,
                                     (weights or {}).get(name), workdir, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = dict(_build.LAUNCHES)
    return out


def assemble_seq_grad(results, n):
    """The seq leg's global gradient [2d, 512, 6] from the ranks' blocks."""
    d, _ = seq_grid(n)
    grad = np.zeros((2 * d, SEQ_T, SEQ_C), np.float32)
    for r in results:
        g = r[SEQ_LEG]
        grad[np.ix_(g["rows"], g["frames"])] = g["grad"]
    return grad


def dryrun_multichip(n, device="cuda", backend="gloo", check=True, legs=LEGS + (SEQ_LEG,),
                     timeout=900.0, seed=0, prefix=""):
    """Spawn ``n`` ranks on ``device`` ("cuda": every rank on ``cuda:rank %
    cards``, or "cpu") over ``backend``, run one step of each leg, print
    a line a leg (after ``prefix``) and return (the ranks' results, the
    one-process references or None).  With ``check``, each leg's loss must
    lie within ``LOSS_RTOL`` of the leg's one-process step on the global
    batch (run here, on the same device), each rank's parameters after the
    step and the seq leg's gradient within ``GRAD_TOL``; every loss must
    be finite."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    devices = [f"cuda:{r % cards}" if cards else "cpu" for r in range(n)]
    results = pmesh.spawn(_spawned_rank, n, args=(devices, legs, seed), backend=backend,
                          timeout=timeout)
    refs = reference_steps(n, devices[0], legs, seed) if check else None
    d, s = seq_grid(n)
    for name in legs:
        loss = results[0][name]["loss"]
        if not all(np.isfinite(r[name]["loss"]) and r[name]["loss"] == loss
                   for r in results):
            raise AssertionError(f"{name}: ranks' losses {[r[name]['loss'] for r in results]}")
        if refs is not None:
            ref = refs[name]["loss"]
            if abs(loss - ref) > LOSS_RTOL * abs(ref):
                raise AssertionError(f"{name}: loss {loss} over {n} ranks, {ref} in one "
                                     f"process (rtol {LOSS_RTOL})")
            if name == SEQ_LEG:
                np.testing.assert_allclose(assemble_seq_grad(results, n),
                                           refs[name]["grad"], **GRAD_TOL)
            else:
                for r in results:
                    for key, ref_param in refs[name]["params"].items():
                        np.testing.assert_allclose(
                            r[name]["params"][key], ref_param, **GRAD_TOL,
                            err_msg=f"{name}: parameter {key} after the step")
        what = f"seq-parallel ctc (mesh {d}x{s})" if name == SEQ_LEG else name
        print(f"{prefix}dryrun_multichip({n}): {what} loss={loss:.4f} ok", flush=True)
    return results, refs


def _spawned_rank(rank, n, devices, legs, seed):
    return rank_main(rank, n, devices[rank], legs, None, seed)


def reference_steps(n, device, legs=LEGS + (SEQ_LEG,), seed=0):
    """Each leg as one process on its global batch."""
    device = torch.device(device)
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        for name in legs:
            if name == SEQ_LEG:
                out[name] = seq_step(n, device, None, seed)
            else:
                out[name] = leg_step(name, n, device, None, None, workdir, seed)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=2, help="ranks")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    parser.add_argument("--no_check", action="store_true",
                        help="skip the one-process references")
    parser.add_argument("--timeout", type=float, default=900.0)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend, not args.no_check,
                     timeout=args.timeout)


if __name__ == "__main__":
    main()
