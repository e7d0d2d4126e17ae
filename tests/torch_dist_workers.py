"""Rank functions of the port's multi-process tests.

``parallel.mesh.spawn`` starts them in fresh processes with the ``spawn``
method, so this module imports torch and the port only (never JAX): each
function returns numbers and numpy arrays to the test, which holds them
against JAX in its own process.
"""

import torch

from gtn_applications_tpu_torch import dryrun, utils
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.models import TDS, TDS2d
from gtn_applications_tpu_torch.parallel import mesh as pmesh

# the narrow TDS2d of the port's train tests (tests/test_torch_train.py)
PAD_MODEL = {
    "depth": 2,
    "tds_groups": [
        {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
        {"channels": 8, "num_blocks": 1, "stride": [2, 1]},
    ],
    "kernel_size": [3, 5],
    "dropout": 0.0,
}
# the padding case's global batch: synthetic train samples whose widths
# differ between the two halves, so that each rank pads to its own width
PAD_ROWS = (0, 1, 2, 3, 4, 5, 6, 7)
PAD_LR = 0.02


def pad_case_samples():
    """(preprocessor, per-rank sample lists) of the padding case: rows
    sorted by width, the narrow half to rank 0, the wide half to rank 1."""
    pre = synthetic.Preprocessor(None, num_features=16)
    ds = synthetic.Dataset(None, pre, split="train")
    rows = sorted(PAD_ROWS, key=lambda i: ds[i][0].shape[1])
    half = len(rows) // 2
    return pre, [[ds[i] for i in rows[:half]], [ds[i] for i in rows[half:]]]


def pad_step(rank, weights):
    """One CTC step of the narrow TDS2d on this rank's half of the padding
    case, collated to its own width and padded to the widest rank's by
    ``train.shard_batch``; returns the loss, the widths and the new
    parameters."""
    pre, halves = pad_case_samples()
    inputs, _, targets = utils.padding_collate(halves[rank])
    local_width = inputs.shape[2]
    mesh = train_mod.make_mesh()
    x = train_mod.shard_batch(inputs, mesh, train_mod.input_time_axis(inputs, 16))
    model = TDS2d(input_size=16, output_size=pre.num_tokens + 1, **PAD_MODEL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    crit = CTC(pre.num_tokens)
    step = train_mod.make_train_step(model, crit, PAD_LR, PAD_LR, 5.0, mesh.group("data"))
    loss, outputs = step(x, crit.prepare(targets), torch.Generator(), 1.0)
    return {"loss": float(loss), "local_width": local_width, "width": x.shape[2],
            "rows": outputs.shape[0],
            "params": {k: v.detach().numpy() for k, v in model.state_dict().items()}}


def meters_sync(rank):
    """``Meters.sync`` of rank-dependent counts."""
    meters = utils.Meters(loss=1.5 + rank, num_samples=3 + rank, num_tokens=10 * (rank + 1),
                          edit_distance_tokens=rank, num_words=2, edit_distance_words=1)
    meters.sync()
    return [meters.loss, meters.num_samples, meters.num_tokens,
            meters.edit_distance_tokens, meters.num_words, meters.edit_distance_words]


def dryrun_against_jax(rank, n, weights, pad_weights):
    """The dry run's legs from JAX's weights, the padding case and
    ``Meters.sync``, on this rank."""
    torch.set_num_threads(1)
    out = dryrun.rank_main(rank, n, "cpu", dryrun.LEGS, weights)
    out["pad"] = pad_step(rank, pad_weights)
    out["sync"] = meters_sync(rank)
    return out


def seq_ctc(rank, n, cases):
    """The seq leg's assoc CTC over a ``('data', 'seq')`` grid of ``1 x n``
    on each case (lp [B, T, C] numpy, targets, target lengths, input
    lengths or None, chunk): this rank's score sum and gradient block."""
    from gtn_applications_tpu_torch.ops import lattice

    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(n)
    out = []
    for lp, targets, lens, input_lengths, chunk in cases:
        x = pmesh.shard_batch_time(torch.from_numpy(lp), mesh, 1).clone().requires_grad_(True)
        il = None if input_lengths is None else torch.from_numpy(input_lengths)
        score = lattice.ctc_forward_score_assoc(
            x, torch.from_numpy(targets), torch.from_numpy(lens), lp.shape[2] - 1,
            il, chunk=chunk, seq_group=mesh.group("seq")).sum()
        score.backward()
        out.append((float(score), x.grad.numpy()))
    return out


def train_run(rank, n, train_argv, test_argv):
    """``train.train`` on this rank; returns its history and the test
    split's meters through ``test.run_test``."""
    from gtn_applications_tpu_torch import test as test_mod

    torch.set_num_threads(1)
    _, history = train_mod.train(train_mod.parse_args(train_argv))
    meters = test_mod.run_test(test_mod.parse_args(test_argv))
    return {"history": history, "test": [meters.avg_loss, meters.cer, meters.wer,
                                         meters.num_samples]}


def train_ranks(rank, n, train_argv, test_argv, seq_argv, seq_test_argv):
    """``train_run``, then ``train_run`` with ``optim.seq_parallel``
    dividing the world: its history and test meters under "seq", and how
    many of its batches (train, validation and test) ran on time shards
    and how many kept time whole under "seq_batches"."""
    out = train_run(rank, n, train_argv, test_argv)
    shard_time, sharded = train_mod.shard_time, []

    def recording(*args):
        batch, axis = shard_time(*args)
        sharded.append(axis is not None)
        return batch, axis

    train_mod.shard_time = recording
    try:
        out["seq"] = train_run(rank, n, seq_argv, seq_test_argv)
    finally:
        train_mod.shard_time = shard_time
    out["seq_batches"] = [sum(sharded), len(sharded) - sum(sharded)]
    return out


SEQ_MODEL = {
    "depth": 2,
    "tds_groups": [
        {"channels": 4, "num_blocks": 1, "stride": [2, 1]},
        {"channels": 8, "num_blocks": 1, "stride": [2, 2]},
    ],
    "dropout": 0.0,
}


def seq_model(kind, kernel, n_out):
    """The small encoder of the sequence-parallel tests: TDS2d (depth 2,
    channels 4 and 8, time strides 1 and 2) or, for the gathered route, the
    1-D TDS, on 16 features."""
    if kind == "tds":
        return TDS(16, n_out, [{"channels": 2, "num_blocks": 1, "stride": 2}], kernel[1], 0.0)
    return TDS2d(input_size=16, output_size=n_out, kernel_size=kernel, **SEQ_MODEL)


def seq_steps(rank, n, seq, cases):
    """``train.make_train_step`` on the ``('data', 'seq')`` grid that
    ``seq`` makes of the world, on each case: (encoder kind, kernel,
    weights, criterion options, global inputs [B, 16, W], targets, lr,
    max_grad_norm, steps).  This rank takes its data rows, pads to the
    step's width and its time shard (``train.shard_time``).  Returns a
    case's losses, its rows, the time axis it was sharded along (None if
    whole), its first step's outputs and the parameters after the first
    and the last step."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(seq)
    out = []
    for kind, kernel, weights, crit_kw, inputs, targets, lr, max_norm, steps in cases:
        crit = CTC(**crit_kw)
        model = seq_model(kind, kernel, crit_kw["blank"] + 1)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
        step = train_mod.make_train_step(model, crit, lr, lr, max_norm, mesh.group("data"),
                                         mesh.group("seq"))
        rows = pmesh.shard_batch(torch.arange(inputs.shape[0]), mesh).numpy()
        x = train_mod.shard_batch(torch.from_numpy(inputs[rows]), mesh, 2)
        x, axis = train_mod.shard_time(x, mesh, 2, model)
        prepared = crit.prepare([targets[i] for i in rows])
        losses, params = [], []
        for k in range(steps):
            loss, outputs = step(x, prepared, torch.Generator(), 1.0, None, axis)
            losses.append(float(loss))
            if k == 0:
                first_outputs = outputs.numpy()
            if k in (0, steps - 1):
                params.append({k: v.detach().numpy().copy()
                               for k, v in model.state_dict().items()})
        out.append({"losses": losses, "rows": rows, "axis": axis, "outputs": first_outputs,
                    "first": params[0], "last": params[-1]})
    return out
