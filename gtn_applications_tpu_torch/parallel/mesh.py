"""Process grid and batch-sharding helpers on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX runs one
process per host over a device ``Mesh`` and lets XLA insert the
collectives; the port runs one process per device (NCCL on CUDA at
``cuda:LOCAL_RANK``, gloo on the CPU), and each process feeds its own rows.
A ``Mesh`` here is the grid of ranks, 1-D ``('data',)`` or 2-D ``('data',
'seq')``, with a process group per axis (``init_device_mesh``).

The global batch of a step is the concatenation of the ranks' local
batches along ``'data'``: ``local x data ranks`` rows.  Where every rank
holds the same global array (the dryrun), ``shard_batch`` and
``shard_batch_time`` take this rank's rows or time slice; where each rank
loaded its own rows (``train.py``), it keeps them.  JAX's helpers that
stitch local rows into one global array have no function here:

  ==============================  =========================================
  JAX ``parallel/mesh.py``        the port
  ==============================  =========================================
  ``global_batch_from_local``     the rank's own rows, as a tensor; every
                                  rank padded to the step's widest time
                                  extent (``train.shard_batch``)
  ``global_pytree_from_local``    the rank's own prepared targets, as they
  (and ``train.shard_prepared``)  are (each rank's criterion scores its
                                  own rows)
  ``local_rows``                  the step's outputs, as they are (each
                                  rank decodes its own rows, and
                                  ``utils.Meters.sync`` sums the counts)
  ==============================  =========================================

Collectives go through ``all_reduce``, ``all_gather`` and ``broadcast``
below; the sequence-parallel step's differentiable ones are
``all_gather_replicated`` (and ``gather_time``), ``halo_exchange`` (the
frames a time shard's convolution reads from its neighbours) and
``all_reduce_sum`` (statistics over every shard's frames), autograd
Functions written here with the gradient conventions of a loss that every
rank of the ``'seq'`` group computes alike.  Gloo serves several ranks on one card (NCCL refuses two ranks on
one device): it takes CUDA tensors for each of these collectives.  NCCL
takes CUDA tensors only, so a host tensor (a width, the meters) visits
this rank's card for it.
"""

import logging
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

_warned_indivisible = set()


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------


class Mesh:
    """A grid of ranks with named axes.  ``shape[i]`` ranks lie along
    ``axis_names[i]``; ``group(name)`` is the process group of this rank's
    line along that axis (None in a single process), ``coord(name)`` this
    rank's index on it."""

    def __init__(self, shape, axis_names, device_mesh=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    def dim(self, name):
        """Ranks along ``name`` (1 for an axis the grid lacks)."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def group(self, name):
        if self.device_mesh is None or name not in self.axis_names:
            return None
        return self.device_mesh.get_group(name)

    def coord(self, name):
        if self.device_mesh is None or name not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(name)


def world():
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(seq_parallel=1):
    """The grid over every rank: 1-D ``('data',)`` by default; 2-D
    ``('data', 'seq')`` when ``seq_parallel`` (time shards) divides the
    world, else data-only with JAX's warning.  A process group per axis
    (``torch.distributed.device_mesh.init_device_mesh``; its device type
    is "cuda" on NCCL and "cpu" on gloo, whose groups carry CUDA tensors
    too)."""
    _, n = world()
    shape, names = (n,), ("data",)
    if seq_parallel > 1:
        if n % seq_parallel == 0:
            shape, names = (n // seq_parallel, seq_parallel), ("data", "seq")
        else:
            logging.warning(
                "seq_parallel=%d does not divide %d devices; using a "
                "data-only mesh", seq_parallel, n,
            )
    if n == 1:
        return Mesh(shape, names)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, names, init_device_mesh(device_type, shape, mesh_dim_names=names))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _on_backend(x, group):
    """A copy of ``x`` the group's backend takes: on this rank's card for
    NCCL."""
    if not x.is_cuda and dist.get_backend(group) == "nccl":
        return x.cuda()
    return x.clone()


def all_reduce(x, group=None, op=dist.ReduceOp.SUM):
    """The reduction of ``x`` over ``group``, a new tensor on ``x``'s
    device; ``x`` itself where there is no group."""
    if group is None and not dist.is_initialized():
        return x
    y = _on_backend(x, group)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def all_gather(x, group=None):
    """[n, *x.shape]: every rank's ``x`` in the group's rank order."""
    if group is None and not dist.is_initialized():
        return x[None]
    y = _on_backend(x, group).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.stack(parts).to(x.device)


def broadcast(x, src=0, group=None):
    """A fresh copy of global rank ``src``'s ``x`` on every rank."""
    if group is None and not dist.is_initialized():
        return x.clone()
    y = _on_backend(x, group)
    dist.broadcast(y, src=src, group=group)
    return y.to(x.device)


class _GatherOwnGrad(torch.autograd.Function):
    """All-gather whose backward keeps this rank's slice of its own
    cotangent.  Every rank of the group computes the same replicated
    function of the gathered stack, so rank r's cotangent of slice r is
    already the whole gradient of that slice; ``torch.distributed.nn``'s
    gather sums every rank's cotangent, which would count it once per
    rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def all_gather_replicated(x, group):
    """``all_gather`` for a function every rank of ``group`` computes alike:
    the gradient flows to each rank's own ``x`` once."""
    if group is None:
        return x[None]
    return _GatherOwnGrad.apply(x, group)


def gather_time(x, group, axis=1):
    """The group's time shards of ``x`` joined along ``axis`` in rank
    order (group rank 0's frames first), differentiable as
    ``all_gather_replicated``; ``x`` itself where there is no group."""
    if group is None:
        return x
    parts = all_gather_replicated(x, group)
    return torch.cat(tuple(parts.unbind(0)), dim=axis)


class _HaloExchange(torch.autograd.Function):
    """``x`` [..., W] of a time shard extended along its last axis by the
    ``h`` frames on either side that its time neighbours hold (zeros at the
    global ends).  Every rank's two edges go through one all-gather (gloo's
    send and recv take CPU tensors only, and ranks sharing a card run
    gloo).  The backward returns each halo's cotangent to the rank that
    owns those frames, also by one all-gather, and adds it there."""

    @staticmethod
    def forward(ctx, x, h, group):
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        ctx.h, ctx.group, ctx.rank, ctx.n = h, group, rank, n
        edges = all_gather(torch.stack([x[..., :h], x[..., -h:]]), group)
        left = edges[rank - 1, 1] if rank > 0 else torch.zeros_like(x[..., :h])
        right = edges[rank + 1, 0] if rank < n - 1 else torch.zeros_like(x[..., :h])
        return torch.cat([left, x, right], dim=-1)

    @staticmethod
    def backward(ctx, g):
        h, rank, n = ctx.h, ctx.rank, ctx.n
        halos = all_gather(torch.stack([g[..., :h], g[..., -h:]]), ctx.group)
        dx = g[..., h:-h].clone()
        if rank > 0:  # the left neighbour's right halo is this rank's first h frames
            dx[..., :h] += halos[rank - 1, 1]
        if rank < n - 1:  # the right neighbour's left halo, its last h frames
            dx[..., -h:] += halos[rank + 1, 0]
        return dx, None, None


def halo_exchange(x, h, group):
    """``x`` [..., W_local], this rank's contiguous time shard along its
    last axis, with ``h`` frames of each neighbouring shard on either side
    ([..., h + W_local + h]; zeros beyond the first and the last shard, the
    global array's zero padding), so that a convolution of width 2 h + 1
    without time padding gives this shard's frames of the global
    convolution.  Needs W_local >= h on every rank.  ``x`` itself where
    ``h`` is 0 or there is no group."""
    if group is None or h == 0:
        return x
    return _HaloExchange.apply(x, h, group)


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward all-reduces the cotangent: every
    rank's loss reads the sum through its own frames only (the logits are
    gathered with ``all_gather_replicated``), so the gradient of the sum is
    the sum of the ranks' cotangents, and each term's is that whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def all_reduce_sum(x, group):
    """The differentiable sum of ``x`` over ``group`` (statistics over
    every time shard); ``x`` itself where there is no group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------


def batch_spec(ndim, axis_name="data"):
    """JAX's partition spec of a batch: its leading axis along
    ``axis_name``, the others whole."""
    return (axis_name,) + (None,) * (ndim - 1)


def _warn_once(key, msg, *args):
    if key not in _warned_indivisible:
        _warned_indivisible.add(key)
        logging.warning(msg, *args)


def _slice(x, axis, n, i):
    size = x.shape[axis] // n
    index = [slice(None)] * x.ndim
    index[axis] = slice(i * size, (i + 1) * size)
    return x[tuple(index)]


def shard_batch(batch, mesh, axis_name="data"):
    """This rank's rows of a global batch (every rank holds the same
    array): the ``mesh.coord(axis_name)``-th of ``mesh.dim(axis_name)``
    equal blocks of the leading axis.  Where they do not divide, every rank
    keeps the whole batch, with JAX's one-shot warning: correct, since the
    step weighs each rank's loss by its rows (``train.make_train_step``),
    but n times the compute."""
    batch = torch.as_tensor(batch)
    n = mesh.dim(axis_name)
    if n > 1 and batch.shape[0] % n == 0:
        return _slice(batch, 0, n, mesh.coord(axis_name))
    if n > 1:
        _warn_once(
            (batch.shape[0], n),
            "Batch size %d not divisible by %d devices: replicating the "
            "batch (each device computes all samples — %dx wasted "
            "compute). Pick batch_size divisible by the device count.",
            batch.shape[0], n, n,
        )
    return batch


def shard_batch_time(batch, mesh, time_axis):
    """This rank's rows along ``'data'`` and contiguous time slice along
    ``'seq'`` (slice 0 holds frame 0).  Either axis is kept whole, with the
    one-shot warning, where its extent does not divide."""
    batch = torch.as_tensor(batch)
    for axis, name in ((0, "data"), (time_axis, "seq")):
        n = mesh.dim(name)
        if n <= 1 or not 0 <= axis < batch.ndim or (name == "seq" and axis == 0):
            continue
        if batch.shape[axis] % n == 0:
            batch = _slice(batch, axis, n, mesh.coord(name))
        else:
            _warn_once(
                (batch.shape[axis], name, n),
                "axis %d extent %d not divisible by %d '%s' shards: "
                "replicating along that mesh axis", axis, batch.shape[axis], n, name,
            )
    return batch


def _is_array(x):
    return isinstance(x, torch.Tensor) or (
        hasattr(x, "shape") and hasattr(x, "dtype") and getattr(x, "ndim", 0) >= 1)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_pytree_batch(tree, mesh, axis_name="data"):
    """``shard_batch`` on every tensor or numpy leaf of a prepared-targets
    tree with a leading axis (an indivisible one stays whole); other leaves,
    such as arc tables, pass as they are, so a rank prepares its own
    targets where they hold per-sample rows."""
    def put(x):
        if _is_array(x) and x.ndim >= 1:
            return shard_batch(x, mesh, axis_name)
        return x

    return _map_tree(put, tree)


def _replicate_leaf(x):
    if isinstance(x, torch.Tensor):
        return broadcast(x.detach(), 0)
    return x


def replicate(tree):
    """Fresh copies of rank 0's tensors in a tree (dict, list, tuple) on
    every rank; for an ``nn.Module``, its parameters and buffers are
    overwritten in place by rank 0's and the module returned."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                t.copy_(_replicate_leaf(t))
        return tree
    return _map_tree(_replicate_leaf, tree)


def pad_to_group_max(x, axis, group, value=0.0):
    """``x`` zero-padded along ``axis`` to the largest extent any rank of
    ``group`` holds there (one MAX all-reduce of the extent)."""
    if group is None:
        return x
    n = int(all_reduce(torch.tensor([x.shape[axis]]), group, dist.ReduceOp.MAX)[0])
    if n == x.shape[axis]:
        return x
    pad = list(x.shape)
    pad[axis] = n - x.shape[axis]
    return torch.cat([x, x.new_full(pad, value)], dim=axis)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------


def free_port():
    """A free TCP port on localhost for ``tcp://localhost:<port>``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, init_method, backend, args, results):
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=nprocs,
                                rank=rank)
        try:
            out = fn(rank, nprocs, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs, args=(), backend="gloo", timeout=600.0):
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` processes started with
    the ``spawn`` method, joined in a process group (``backend``, rendezvous
    at ``tcp://127.0.0.1:<free port>``).  ``fn`` must be importable at
    module level and return picklable host data (numbers, numpy arrays).
    Returns the results in rank order.  A rank that raises, dies, or does
    not finish within ``timeout`` seconds gets every rank killed and the
    call raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, nprocs, init_method, backend, args, results))
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    out, error = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs and error is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    error = f"ranks {sorted(set(range(nprocs)) - set(out))} did not " \
                            f"finish within {timeout:.0f} s"
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and error is None:
                    error = f"a rank exited with code {dead[0]} before reporting"
                continue
            if ok:
                out[rank] = payload
            else:
                error = f"rank {rank} raised:\n{payload}"
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) if error is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
    if error is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, {nprocs}): {error}")
    return [out[r] for r in range(nprocs)]


def local_rank():
    """``LOCAL_RANK`` of torchrun's environment, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))
