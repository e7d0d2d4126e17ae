"""Training entry point (PyTorch): one process per device.

Counterpart of ``gtn_applications_tpu/train.py``: JSON experiment configs,
the epoch loop with SGD and a halving learning-rate schedule, global-norm
gradient clipping, per-epoch train and validation CER/WER (train CER/WER on
every ``optim.metrics_interval``-th step), best-checkpoint tracking and
restore, and a profiler trace of the first epoch (``--profile_dir``) with
the spans of ``utils.Recorder`` on its time axis.  Each epoch installs a
recorder, whose span totals and the step's first and last CUDA-event
marks give the "Timing Info" log line (``timing_info``); ``make_train_step``,
``make_eval_step``, ``prepared_batches``, ``_to_device`` and ``evaluate``
record into whichever recorder a caller installs (none: one test each).

Distribution: one process per device over ``torch.distributed``, the grid
of ``parallel.mesh``.  Each data rank loads its own rows (the sampler
deals chunk ``d + i * data_ranks`` to data coordinate d), so the global
batch is ``batch_size`` rows, ``batch_size // data_ranks`` a rank; the
step's gradient is that of the global batch's loss, reduced over the
ranks before the global-norm clip.  Rendezvous by the flags
(``--world_size``, ``--coordinator_address host:port``, ``--process_id``,
as JAX's) or by torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); NCCL on CUDA at
``cuda:LOCAL_RANK``, gloo on the CPU.  Only rank 0 logs.

Sequence parallelism (``optim.seq_parallel`` = n dividing the world: a
``('data', 'seq')`` grid): the ranks of a ``'seq'`` line hold the same
rows, padded to one width across the whole step, and each keeps a
contiguous 1/n of the time axis through the encoder (JAX shards the
inputs' time axis and lets XLA partition).  TDS2d runs on its shard
(halos and statistics across shards, ``models/tds2d.py``); other encoders
gather their input and run whole on each rank, keeping their shard of the
output.  The criterion scores the global batch on every rank of the line
(``Criterion.seq_loss``: the assoc CTC from its shards, others on the
gathered log-probabilities), and each rank's backward yields its frames'
share of the model's gradient, so the step sums the gradients over
``'seq'`` and ``'data'`` at once and divides by the global rows (the
criterion's parameters, scored after the gather, count once a line).  A
width whose shards do not fit the encoder keeps time whole on every rank,
with a one-shot warning.  A world it does not divide keeps JAX's
data-only fallback and warning.

Runs on CUDA unless ``--disable_cuda`` asks for the CPU; without that flag
and without a GPU it raises.  TF32 is switched off for cuDNN convolutions
and cuBLAS matmuls: the reference numbers are fp32.

    python -m gtn_applications_tpu_torch.train --config CONFIG.json \
        --checkpoint_path DIR [--disable_cuda]
    torchrun --nproc_per_node 2 -m gtn_applications_tpu_torch.train \
        --config CONFIG.json --checkpoint_path DIR
"""

import argparse
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from . import utils
from .ops.sparse import ArcTable
from .parallel import mesh as pmesh


def add_distributed_args(parser):
    """JAX's rendezvous flags."""
    parser.add_argument(
        "--world_size", default=0, type=int,
        help="Number of processes (0: torchrun's WORLD_SIZE, else one)",
    )
    parser.add_argument("--coordinator_address", default=None, type=str,
                        help="host:port of rank 0's rendezvous")
    parser.add_argument("--process_id", default=None, type=int,
                        help="This process's rank (with --coordinator_address)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a handwriting / speech recognition model."
    )
    parser.add_argument("--config", type=str, help="JSON configuration file.")
    parser.add_argument(
        "--disable_cuda", action="store_true", help="Run on the CPU."
    )
    parser.add_argument("--restore", action="store_true")
    parser.add_argument("--last_epoch", type=int, default=0)
    parser.add_argument("--checkpoint_path", default="/tmp/", type=str)
    parser.add_argument(
        "--profile_dir", default=None, type=str,
        help="Write a torch.profiler trace of the first training epoch, with "
        "the recorder's spans, into this directory (trace_rank<r>.json)",
    )
    add_distributed_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args


def init_distributed(args, device):
    """Join a process group (NCCL on CUDA, gloo on the CPU) as ``args`` or
    torchrun's environment say; returns True if this call created it
    (False where neither asks for one, or one exists already)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if getattr(args, "coordinator_address", None) is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{args.coordinator_address}",
            world_size=args.world_size or 1, rank=args.process_id or 0,
        )
        return True
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return True
    return False


def select_device(disable_cuda=False):
    """The device an entry point runs on: the CPU, or the card of this
    process's local rank (``LOCAL_RANK``, else the global rank, modulo the
    cards); full fp32 math on CUDA."""
    if disable_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --disable_cuda to run on the CPU"
        )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    index = pmesh.local_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


# the grid of ranks: ('data',), or ('data', 'seq') where seq_parallel
# time shards divide the world
make_mesh = pmesh.make_mesh


def input_time_axis(inputs, num_features):
    """Time axis of a padded input batch: image layout [B, H=num_features,
    W=time] -> 2; feature-stream layout [B, T=time, F=num_features] -> 1.
    None for non-3D inputs."""
    if np.ndim(inputs) != 3:
        return None
    return 2 if inputs.shape[1] == num_features else 1


def shard_batch(batch, mesh, time_axis=None):
    """This rank's rows of the step's global batch, as a tensor: its own
    local batch (JAX's ``global_batch_from_local``), zero-padded along
    ``time_axis`` to the widest rank's width in the step (every rank of
    the grid), so that every rank's rows are those of one global array
    (the padded frames count where the criterion scores them: CTC without
    input lengths, STC's division by T).  Its prepared targets and outputs
    are its own rows as they are (JAX's ``shard_prepared`` and
    ``local_rows`` have no counterpart)."""
    batch = torch.as_tensor(batch)
    if time_axis is not None and mesh.size > 1:
        batch = pmesh.pad_to_group_max(batch, time_axis, dist.group.WORLD)
    return batch


def time_shards_fit(model, width, n):
    """Whether a global width splits into ``n`` time shards for ``model``:
    its own rule where it runs on a shard (``TDS2d.fits_time_shards``),
    else equal input shards and an output length that n divides."""
    fits = getattr(model, "fits_time_shards", None)
    if fits is not None:
        return fits(width, n)
    return width % n == 0 and -(-width // getattr(model, "time_stride", 1)) % n == 0


def shard_time(batch, mesh, time_axis, model):
    """(this rank's contiguous time slice of ``batch`` along ``'seq'``,
    ``time_axis``) where the grid has a ``'seq'`` axis and the width fits
    the model's shards (``time_shards_fit``); else (``batch``, None),
    with the one-shot warning where the width does not fit."""
    n = mesh.dim("seq")
    if n <= 1 or time_axis is None:
        return batch, None
    width = batch.shape[time_axis]
    if not time_shards_fit(model, width, n):
        pmesh._warn_once(
            ("seq", width, n),
            "time extent %d does not fit %d 'seq' shards of %s: keeping time whole "
            "on every 'seq' rank", width, n, type(model).__name__,
        )
        return batch, None
    return pmesh._slice(batch, time_axis, n, mesh.coord("seq")), time_axis


def encode(model, inputs, train=False, generator=None, seq_group=None, time_axis=None):
    """The model's outputs [B, T', C]; with a ``seq_group``, ``inputs`` is
    this rank's time shard along ``time_axis`` and the result its shard of
    the outputs [B, T' / n, C].  A model without a sharded forward (only
    TDS2d has one) gathers its input along time and runs whole on every
    rank of the group, keeping its shard of the output."""
    if seq_group is None:
        return model(inputs, train=train, generator=generator)
    if hasattr(model, "fits_time_shards"):
        return model(inputs, train=train, generator=generator, seq_group=seq_group)
    pmesh._warn_once(
        ("seq whole", type(model).__name__),
        "%s has no time-sharded forward: each 'seq' rank gathers its input along "
        "time and runs the encoder whole", type(model).__name__,
    )
    whole = torch.cat(tuple(pmesh.all_gather(inputs, seq_group).unbind(0)), dim=time_axis)
    outputs = model(whole, train=train, generator=generator)
    return pmesh._slice(outputs, 1, dist.get_world_size(seq_group),
                        dist.get_rank(seq_group))


def clip_global_norm(grads, max_norm):
    """Scale ``grads`` in place by min(1, max_norm / max(||grads||, 1e-6))."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads


def _data_group(group):
    """``group`` where it spans more than one rank, else None."""
    if group is None or not dist.is_initialized() or dist.get_world_size(group) == 1:
        return None
    return group


def reduce_gradients(grads, weighted_loss, n_local, group):
    """One SUM all-reduce over ``group`` of the gradients of ``loss x
    n_local`` flattened with that product and ``n_local``; everything
    divided by the global row count.  Returns (gradients of the global
    batch's mean loss, that loss)."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [weighted_loss.reshape(1).to(grads[0].dtype),
                        torch.tensor([float(n_local)], dtype=grads[0].dtype,
                                     device=grads[0].device)])
    flat = pmesh.all_reduce(flat, group)
    flat = flat[:-1] / flat[-1]
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out, flat[-1]


def _train_step_body(model, criterion, lr_model, lr_crit, max_grad_norm, group=None,
                     seq_group=None):
    """The train step shared by ``make_train_step`` and
    ``make_fused_train_steps``."""
    model_params = list(model.parameters())
    crit_params = list(criterion.params.values())
    group, seq_group = _data_group(group), _data_group(seq_group)

    def step(inputs, prepared, generator, lr_scale, input_lengths=None, time_axis=None):
        with utils.span("step"):
            params = model_params + crit_params
            with utils.span("zero_grad"):
                for p in params:
                    p.grad = None
            sharded = seq_group is not None and time_axis is not None
            with utils.span("forward"):
                utils.mark("forward")
                if sharded:
                    outputs = encode(model, inputs, True, generator, seq_group, time_axis)
                else:
                    outputs = model(inputs, train=True, generator=generator)
                utils.mark("forward.end")
            with utils.span("loss"):
                if sharded:
                    loss = criterion.seq_loss(criterion.params, outputs, prepared,
                                              input_lengths, seq_group)
                else:
                    loss = criterion.loss(criterion.params, outputs, prepared, input_lengths)
            reduced = group is not None or seq_group is not None
            with utils.span("backward"):
                # splits the criterion's backward from the encoder's
                utils.mark_grad(outputs, "outputs.grad")
                if not reduced:
                    loss.backward()
                    grads = [p.grad for p in params]
                else:
                    # every criterion returns its batch mean: the global
                    # batch's loss is sum_r loss_r B_r / B, so each rank
                    # differentiates loss_r B_r and the reduction divides by B
                    n_local = inputs.shape[0]
                    (loss * n_local).backward()
                    grads = [torch.zeros_like(p) if p.grad is None else p.grad
                             for p in params]
                utils.mark("backward.end")
            with utils.span("optimizer"):
                if reduced:
                    weighted = loss.detach() * n_local
                    if seq_group is None:
                        grads, loss = reduce_gradients(grads, weighted, n_local, group)
                    else:
                        # the ranks of a 'seq' line compute one loss: on time
                        # shards each holds its frames' share of the model's
                        # gradient, summed over 'seq' and 'data' in one
                        # all-reduce over the grid; the criterion's parameters
                        # (used after the gather), and every parameter with
                        # time whole, get the whole gradient on each rank,
                        # which the line's first rank alone adds.  The loss
                        # and the rows count once a line.
                        first = float(dist.get_rank(seq_group) == 0)
                        partial = len(model_params) if sharded else 0
                        grads = grads[:partial] + [g * first for g in grads[partial:]]
                        grads, loss = reduce_gradients(grads, weighted * first,
                                                       n_local * first, dist.group.WORLD)
                if max_grad_norm is not None:
                    clip_global_norm(grads, max_grad_norm)
                with torch.no_grad():
                    for p, g in zip(model_params, grads):
                        p.sub_(lr_model * lr_scale * g)
                    for p, g in zip(crit_params, grads[len(model_params):]):
                        p.sub_(lr_crit * lr_scale * g)
                utils.mark("optimizer.end")
            return loss.detach(), outputs.detach()

    return step


def make_train_step(model, criterion, lr_model, lr_crit, max_grad_norm, group=None,
                    seq_group=None):
    """The train step: forward, loss, backward, gradient reduction over
    ``group`` (the ``'data'`` ranks; None in one process) and ``seq_group``
    (the ``'seq'`` ranks, on a ``('data', 'seq')`` grid), clip, SGD.

    ``step(inputs, prepared, generator, lr_scale, input_lengths=None,
    time_axis=None)`` updates the parameters of ``model`` (and of the
    criterion, if it has any) in place with ``p -= lr * lr_scale * g``,
    where g is the gradient of the global batch's loss clipped to
    ``max_grad_norm`` by its global norm, and returns the detached (global
    batch's loss, this rank's outputs).  ``generator`` draws the dropout
    masks.  ``input_lengths`` (None for reference parity: the reference
    scores the zero-padded frames) masks padded frames out of the lattice;
    on a time shard they count global frames.  ``time_axis``: ``inputs``
    is this rank's time shard along that axis (``shard_time``), and the
    outputs are its shard of the logits."""
    return _train_step_body(model, criterion, lr_model, lr_crit, max_grad_norm, group,
                            seq_group)


def _index_tree(tree, k):
    """Entry ``k`` of every tensor or numpy leaf's leading axis."""
    if isinstance(tree, dict):
        return {key: _index_tree(v, k) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index_tree(v, k) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim >= 1:
        return tree[k]
    return tree


def make_fused_train_steps(model, criterion, lr_model, lr_crit, max_grad_norm,
                           num_steps, group=None):
    """``num_steps`` SGD steps in one call: ``fused(inputs_k, prepared_k,
    generator, lr_scale)`` takes inputs [K, B, ...] and prepared targets
    whose leaves carry a leading [K] axis (one batch shape), runs the step
    of ``make_train_step`` on each k in order (JAX's update order) and
    returns the mean of the K losses.  JAX fuses them into one executable
    to spare a remote TPU's dispatch; here they are K calls."""
    step = _train_step_body(model, criterion, lr_model, lr_crit, max_grad_norm, group)

    def fused(inputs_k, prepared_k, generator, lr_scale):
        losses = [step(inputs_k[k], _index_tree(prepared_k, k), generator, lr_scale)[0]
                  for k in range(num_steps)]
        return torch.stack(losses).mean()

    return fused


def make_eval_step(model, criterion, seq_group=None):
    """``step(inputs, prepared, input_lengths=None, time_axis=None)`` ->
    (loss, outputs) without gradients; on a time shard (``time_axis``,
    over ``seq_group``) the loss of the global batch and the outputs
    gathered along time."""
    seq_group = _data_group(seq_group)

    @torch.no_grad()
    def step(inputs, prepared, input_lengths=None, time_axis=None):
        sharded = seq_group is not None and time_axis is not None
        with utils.span("step"):
            with utils.span("forward"):
                if sharded:
                    outputs = encode(model, inputs, False, None, seq_group, time_axis)
                else:
                    outputs = model(inputs)
            with utils.span("loss"):
                if sharded:
                    loss = criterion.seq_loss(criterion.params, outputs, prepared,
                                              input_lengths, seq_group)
                else:
                    loss = criterion.loss(criterion.params, outputs, prepared, input_lengths)
            if sharded:
                outputs = pmesh.gather_time(outputs, seq_group)
            return loss, outputs

    return step


def output_lengths(model, widths):
    """Map input widths to encoder output frame counts via the model's
    total time stride."""
    stride = getattr(model, "time_stride", 1)
    return torch.as_tensor(-(-np.asarray(widths) // stride), dtype=torch.int32)


def to_device(obj, device):
    """``obj`` with every tensor and numpy array in it (through nested
    tuples, lists, dicts and arc tables) on ``device``; host scalars stay as
    they are."""
    if isinstance(obj, ArcTable):
        return obj.to(device)
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def _to_device(inputs, prepared, device):
    with utils.span("to_device"):
        return torch.as_tensor(inputs).to(device), to_device(prepared, device)


def criterion_to_device(criterion, device, params=None):
    """Set ``criterion.params`` (``params`` if given, e.g. from a
    checkpoint, else its own) to leaves on ``device`` that require grad."""
    params = criterion.params if params is None else params
    criterion.params = {
        k: v.detach().to(device).requires_grad_(True) for k, v in params.items()
    }
    return criterion


def prepared_batches(loader, criterion):
    """``(inputs, widths, targets, criterion.prepare(targets))`` of each
    batch of ``loader``, prepared in turn.  JAX prepares on a background
    thread to overlap the device's steps; on an H100 such a thread made
    the marginalized example's epoch 4.5 % slower, the step and
    ``prepare`` sharing the GIL (``scripts/time_prefetch.py``).  Spans:
    ``fetch`` (the wait on ``loader``) and ``prepare``."""
    for inputs, widths, targets in utils.fetched(loader):
        with utils.span("prepare"):
            prepared = criterion.prepare(targets)
        yield inputs, widths, targets, prepared


def evaluate(model, criterion, data_loader, preprocessor, eval_step, device,
             use_lengths=False, report=None, mesh=None):
    """Meters (loss, CER, WER) over ``data_loader``; ``report``, if given,
    is called with each batch's decoded predictions and targets.  With a
    ``mesh`` of several ranks, each rank scores and decodes its own rows
    (padded to the widest rank's, ``shard_batch``; on a ``'seq'`` axis its
    time shard, the logits gathered before decoding), and the meters are
    summed over the ``'data'`` ranks (``Meters.sync``).  Spans: ``fetch``,
    ``prepare``, ``decode`` (dispatch and finalize) beside those of
    ``_to_device``, the eval step and the meters."""
    mesh = mesh or pmesh.Mesh((1,), ("data",))
    meters = utils.Meters()
    losses = []
    for inputs, widths, targets in utils.fetched(data_loader):
        time_axis = input_time_axis(inputs, preprocessor.num_features)
        inputs, time_axis = shard_time(shard_batch(inputs, mesh, time_axis), mesh,
                                       time_axis, model)
        with utils.span("prepare"):
            prepared = criterion.prepare(targets)
        inputs, prepared = _to_device(inputs, prepared, device)
        lens = output_lengths(model, widths).to(device) if use_lengths else None
        loss, outputs = eval_step(inputs, prepared, lens, time_axis)
        losses.append(loss * len(targets))
        meters.num_samples += len(targets)
        with utils.span("decode"):
            predictions = criterion.viterbi_finalize(
                criterion.viterbi_dispatch(outputs, criterion.params, lens)
            )
        if report is not None:
            report(predictions, targets)
        meters.add_decodes(predictions, targets, preprocessor)
    if losses:
        meters.loss += float(utils.to_host(torch.stack(losses).sum()))
    if mesh.size > 1:
        meters.sync(mesh.group("data"))
    return meters


def test(model, criterion, data_loader, preprocessor, eval_step, device,
         use_lengths=False, mesh=None):
    """Loss, CER and WER over ``data_loader`` (over every rank's rows with
    a ``mesh`` of several ranks)."""
    meters = evaluate(model, criterion, data_loader, preprocessor, eval_step,
                      device, use_lengths, mesh=mesh)
    return meters.avg_loss, meters.cer, meters.wer


def load_experiment(config, generator=None):
    """Shared setup for train.py / test.py: dataset module, preprocessor,
    criterion and model (its parameters drawn from ``generator``)."""
    from . import datasets as ds_pkg

    dataset_name = config["data"]["dataset"]
    if not hasattr(ds_pkg, dataset_name) or dataset_name == "text":
        raise ValueError(f"Unknown dataset {dataset_name}")
    dataset = getattr(ds_pkg, dataset_name)

    input_size = config["data"]["num_features"]
    kwargs = dict(
        num_features=input_size,
        tokens_path=config["data"].get("tokens", None),
        lexicon_path=config["data"].get("lexicon", None),
        prepend_wordsep=config["data"].get("prepend_wordsep", False),
    )
    if dataset_name == "iamdb":
        kwargs["use_words"] = config["data"].get("use_words", False)
    preprocessor = dataset.Preprocessor(config["data"].get("data_path"), **kwargs)
    criterion, output_size = utils.load_criterion(
        config.get("criterion_type", "ctc"),
        preprocessor,
        config.get("criterion", {}),
    )
    model = utils.load_model(
        config["model_type"], input_size, output_size, config["model"],
        generator=generator,
    )
    return dataset, preprocessor, criterion, model, input_size


def dataset_kwargs(config):
    """``data.fast_pipeline`` (iamdb): the float and jitter stages run once
    a batch in the dataset's own collate."""
    return {"fast_pipeline": True} if config["data"].get("fast_pipeline", False) else {}


# the profiler annotation that puts the recorder's spans on the trace's clock
TRACE_CLOCK = "recorder.clock"
# the train step's first and last device marks, all that ``timing_info`` reads
STEP_MARKS = ("forward", "optimizer.end")


def timing_info(train_recorder, val_recorder):
    """The "Timing Info" log line's numbers (ms) from an epoch's recorders:
    the mean host time of each phase of a train step (``enqueue``, the
    step's own, returns before the device has run it), the step's device
    time from its marks (CUDA only), the train epoch and the validation
    pass, each with a synchronise at its end."""
    out = {}
    for name, key in (("fetch", "fetch"), ("prepare", "prepare"), ("to_device", "to_device"),
                      ("step", "enqueue"), ("sync", "sync"), ("meters", "meters")):
        ms = train_recorder.mean_ms(name)
        if ms is not None:
            out[key] = ms
    device = train_recorder.mark_ms(*STEP_MARKS)
    if device is not None:
        out["step_device"] = device
    out["train_total"] = train_recorder.mean_ms("train_epoch")
    out["test_total"] = val_recorder.mean_ms("validation")
    return out


def train(args):
    """Train as ``args`` says, on this rank's share of the process group
    if there is one; returns (model, history), where history holds one
    dict of train/validation metrics per epoch (the same on every rank)."""
    rank, world_size = pmesh.world()
    if rank > 0:
        logging.getLogger().setLevel(logging.CRITICAL)
    device = select_device(getattr(args, "disable_cuda", False))
    with open(args.config, "r") as fid:
        config = json.load(fid)
        logging.info("Using the config \n{}".format(json.dumps(config)))

    mesh = make_mesh(config["optim"].get("seq_parallel", 1))
    seed = config.get("seed", 0)
    init_gen = torch.Generator().manual_seed(seed)
    # each rank its own dropout stream, from (seed, rank); rank 0's is the
    # one-process run's
    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1 + 65536 * rank)

    logging.info("Loading dataset ...")
    dataset, preprocessor, criterion, model, input_size = load_experiment(
        config, init_gen
    )
    data_path = config["data"].get("data_path")
    ds_kwargs = dataset_kwargs(config)
    trainset = dataset.Dataset(data_path, preprocessor, split="train", augment=True,
                               **ds_kwargs)
    valset = dataset.Dataset(data_path, preprocessor, split="validation", **ds_kwargs)
    # the ranks of a 'seq' line read the same rows
    data_rank, data_ranks = mesh.coord("data"), mesh.dim("data")
    train_loader = utils.data_loader(trainset, config, data_rank, data_ranks, seed)
    val_loader = utils.data_loader(valset, config, data_rank, data_ranks, seed)
    # JAX's train draws a first batch to shape its initialisation, and with
    # it one batch order: drawing that order too keeps JAX's epochs' order
    iter(train_loader.sampler)

    model.to(device)
    criterion_to_device(criterion, device)
    if world_size > 1:
        pmesh.replicate(model)
        criterion_to_device(criterion, device, pmesh.replicate(dict(criterion.params)))
    num_updates = 0
    if args.restore:
        template = {"model": model.state_dict(), "criterion": dict(criterion.params),
                    "epoch": 0, "num_updates": 0}
        state = utils.load_checkpoint(args.checkpoint_path, load_last=True,
                                      template=template)
        model.load_state_dict(state["model"])
        criterion_to_device(criterion, device, state["criterion"])
        num_updates = state.get("num_updates", 0)
        logging.info(f"Restored model from epoch {args.last_epoch}")

    n_params = sum(p.numel() for p in model.parameters())
    logging.info(
        "Training {} model with {:,} parameters on {} ({} ranks).".format(
            config["model_type"], n_params, device, world_size
        )
    )

    epochs = config["optim"]["epochs"]
    lr = config["optim"]["learning_rate"]
    crit_lr = config["optim"].get("crit_learning_rate", lr)
    step_size = config["optim"]["step_size"]
    max_grad_norm = config["optim"].get("max_grad_norm", None)
    use_lengths = config["optim"].get("use_input_lengths", False)
    # train CER/WER decodes every metrics_interval-th step (1: every step)
    metrics_interval = config["optim"].get("metrics_interval", 1)
    ckpt_format = config["optim"].get("checkpoint_format", "pickle")

    train_step = make_train_step(model, criterion, lr, crit_lr, max_grad_norm,
                                 mesh.group("data"), mesh.group("seq"))
    eval_step = make_eval_step(model, criterion, mesh.group("seq"))

    min_val_loss = min_val_cer = min_val_wer = float("inf")
    history = []
    for epoch in range(args.last_epoch, epochs):
        profiler = None
        if getattr(args, "profile_dir", None) and epoch == args.last_epoch:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
            clocks = [utils.trace_clock(TRACE_CLOCK)]
        # spans kept for the profiled epoch's trace only; otherwise summed
        # as they close, and the step's two marks folded as it completes
        recorder = utils.Recorder(device, marks=STEP_MARKS, keep=profiler is not None)
        logging.info("Epoch {} started. ".format(epoch + 1))
        lr_scale = 0.5 ** (epoch // step_size)
        criterion.train()
        meters = utils.Meters()
        losses = []
        with utils.recording(recorder), utils.span("train_epoch"):
            for step_idx, (inputs, widths, targets, prepared) in enumerate(
                    prepared_batches(train_loader, criterion)):
                time_axis = input_time_axis(inputs, input_size)
                inputs, time_axis = shard_time(shard_batch(inputs, mesh, time_axis), mesh,
                                               time_axis, model)
                inputs, prepared = _to_device(inputs, prepared, device)
                lens = output_lengths(model, widths).to(device) if use_lengths else None
                loss, outputs = train_step(
                    inputs, prepared, dropout_gen, lr_scale, lens, time_axis
                )
                num_updates += 1
                losses.append(loss * len(targets))
                meters.num_samples += len(targets)
                if step_idx % metrics_interval == 0:
                    if time_axis is not None:
                        outputs = pmesh.gather_time(outputs, mesh.group("seq"))
                    predictions = criterion.viterbi_finalize(criterion.viterbi_dispatch(
                        outputs, criterion.params, lens))
                    meters.add_decodes(predictions, targets, preprocessor)
            if losses:
                meters.loss += float(utils.to_host(torch.stack(losses).sum()))
            if device.type == "cuda":
                torch.cuda.synchronize()
        recorder.resolve()
        if profiler is not None:
            clocks.append(utils.trace_clock(TRACE_CLOCK))
            profiler.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            trace = os.path.join(args.profile_dir, f"trace_rank{rank}.json")
            profiler.export_chrome_trace(trace)
            utils.add_spans_to_trace(trace, recorder, clocks, TRACE_CLOCK)
            logging.info(f"Profiler trace written to {trace}")
        epoch_time = recorder.mean_ms("train_epoch") / 1e3
        if world_size > 1:
            meters.sync(mesh.group("data"))
        logging.info(
            "Epoch {} complete. "
            "nUpdates {}, Loss {:.3f}, CER {:.3f}, WER {:.3f},"
            " Time {:.3f} (s), LR {:.3f}".format(
                epoch + 1, num_updates, meters.avg_loss, meters.cer,
                meters.wer, epoch_time, lr * lr_scale,
            ),
        )
        logging.info("Evaluating validation set..")
        val_recorder = utils.Recorder(keep=False)
        with utils.recording(val_recorder), utils.span("validation"):
            criterion.eval()
            val_loss, val_cer, val_wer = test(
                model, criterion, val_loader, preprocessor, eval_step, device,
                use_lengths, mesh,
            )
            if device.type == "cuda":
                torch.cuda.synchronize()
        # pickle saves from rank 0 only; the collective format on every rank
        if rank == 0 or ckpt_format == "orbax":
            utils.save_checkpoint(
                args.checkpoint_path,
                {
                    "model": model.state_dict(),
                    "criterion": dict(criterion.params),
                    "epoch": epoch,
                    "num_updates": num_updates,
                },
                save_best=(val_cer < min_val_cer),
                format=ckpt_format,
            )
        min_val_loss = min(val_loss, min_val_loss)
        min_val_cer = min(val_cer, min_val_cer)
        min_val_wer = min(val_wer, min_val_wer)
        logging.info(
            "Validation Set: Loss {:.3f}, CER {:.3f}, WER {:.3f}, "
            "Best Loss {:.3f}, Best CER {:.3f}, Best WER {:.3f}".format(
                val_loss, val_cer, val_wer, min_val_loss, min_val_cer,
                min_val_wer,
            ),
        )
        logging.info(
            "Timing Info: "
            + ", ".join("{} : {:.2f}ms".format(k, v)
                        for k, v in timing_info(recorder, val_recorder).items())
        )
        history.append({
            "epoch": epoch + 1, "train_loss": meters.avg_loss,
            "train_cer": meters.cer, "val_loss": val_loss,
            "val_cer": val_cer, "val_wer": val_wer,
        })
    return model, history


def main(argv=None):
    """Parse ``argv``, join the process group it or torchrun's environment
    asks for, train; returns ``train``'s (model, history)."""
    args = parse_args(argv)
    created = init_distributed(args, select_device(args.disable_cuda))
    try:
        return train(args)
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
