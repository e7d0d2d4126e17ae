"""The port's distribution helpers in one process, against the JAX package.

  * ``parallel.mesh.shard_batch`` takes the rows JAX's ``shard_batch`` lays
    on each device of a 2- and a 4-device data mesh, and keeps the whole
    batch (one warning for two calls) where the rows do not divide;
    ``shard_batch_time`` takes the block of rows and frames JAX's lays on
    each device of a 2 x 2 ``('data', 'seq')`` mesh, and keeps an
    indivisible time axis whole; ``input_time_axis`` names JAX's axis.
    A rank's coordinates come from a stand-in for the device mesh.
  * ``utils.BatchSortedSampler`` deals JAX's batches, batch for batch, to
    each rank of worlds of 1-4, with shuffling on and off.
  * ``optim.metrics_interval``: the train meters of an epoch with interval
    3 count exactly the decodes of steps 0, 3 and 6 of a loop that trains
    the same steps (``num_tokens``, ``edit_distance_tokens``).
  * ``prepared_batches`` yields each batch with its prepared targets, and
    the background thread ``scripts/time_prefetch.py`` measures it against
    (JAX's) yields the same batches and raises a loader's exception;
  * ``make_fused_train_steps`` with K = 2 equals two calls of the step
    (bitwise) and JAX's fused steps (loss within atol 1e-4, each update
    within 1e-3 of its norm: ``tests/test_torch_train.py``'s tolerances).
  * Checkpoints in both formats, and the collective one restored by
    ``train.py --restore`` and read by ``test.py``; ``module_from_file``;
    ``train.py``'s rendezvous flags for a world of one over gloo give the
    one-process history (which writes a profiler trace of its epoch with
    ``--profile_dir``); on a grid with a ``'seq'`` axis, ``train.py``'s
    time shard of a rank's rows is the block JAX's ``train.shard_batch``
    lays on that device of a 2 x 2 mesh, and a width the encoder's shards
    do not fit stays whole, with the warning.
"""

import json
import logging
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu import utils as jax_utils
from gtn_applications_tpu.criterions import CTC as JaxCTC
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu.parallel import mesh as jax_mesh
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import tds2d_from_flax
from gtn_applications_tpu_torch.parallel import mesh as pmesh
from gtn_applications_tpu_torch.scripts import time_prefetch

from tests.test_torch_train import MODEL, _updates_match


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores, and a CPU train loop with a thread per core each slows ~70x
    under that contention (as in ``tests/test_torch_ctc_long.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Coords:
    """A device mesh's stand-in: this rank's coordinate on each axis."""

    def __init__(self, coords):
        self.coords = coords

    def get_local_rank(self, name):
        return self.coords[name]

    def get_group(self, name):
        return None


def _port_mesh(shape, names, coords):
    return pmesh.Mesh(shape, names, _Coords(dict(zip(names, coords))))


def _jax_blocks(x, mesh, spec):
    """{device position in the mesh: the block of x JAX lays there}."""
    arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    where = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    return {where[s.device.id]: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_rows_match_jax(n):
    x = np.arange(8 * 3 * 5, dtype=np.float32).reshape(8, 3, 5)
    jmesh = jax_mesh.make_mesh(jax.devices()[:n])
    blocks = _jax_blocks(x, jmesh, P(*jax_mesh.batch_spec(3)))
    assert pmesh.batch_spec(3) == tuple(jax_mesh.batch_spec(3))
    for (i,), block in blocks.items():
        got = pmesh.shard_batch(x, _port_mesh((n,), ("data",), (i,)))
        np.testing.assert_array_equal(got.numpy(), block)
    tree = {"t": (x, np.arange(8)), "s": 3}
    got = pmesh.shard_pytree_batch(tree, _port_mesh((n,), ("data",), (1,)))
    np.testing.assert_array_equal(got["t"][1].numpy(), np.arange(8).reshape(n, -1)[1])
    assert got["s"] == 3


def test_shard_batch_replicates_indivisible_once(caplog):
    x = np.arange(3 * 4, dtype=np.float32).reshape(3, 4)
    mesh = _port_mesh((2,), ("data",), (1,))
    pmesh._warned_indivisible.discard((3, 2))
    with caplog.at_level(logging.WARNING):
        a = pmesh.shard_batch(x, mesh)
        b = pmesh.shard_batch(x, mesh)
    np.testing.assert_array_equal(a.numpy(), x)
    np.testing.assert_array_equal(b.numpy(), x)
    assert sum("not divisible by 2 devices" in r.getMessage() for r in caplog.records) == 1
    # JAX keeps the whole batch on every device too
    arr = jax_mesh.shard_batch(x, jax_mesh.make_mesh(jax.devices()[:2]))
    np.testing.assert_array_equal(np.asarray(arr), x)


def test_shard_batch_time_matches_jax(caplog):
    x = np.arange(4 * 3 * 8, dtype=np.float32).reshape(4, 3, 8)
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    jmesh = JaxMesh(devices, ("data", "seq"))
    arr = jax_mesh.shard_batch_time(x, jmesh, 2)
    where = {d.id: idx for idx, d in np.ndenumerate(jmesh.devices)}
    for shard in arr.addressable_shards:
        got = pmesh.shard_batch_time(x, _port_mesh((2, 2), ("data", "seq"),
                                                   where[shard.device.id]), 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    # an indivisible time axis stays whole, with the warning
    y = x[:, :, :7]
    pmesh._warned_indivisible.discard((7, "seq", 2))
    with caplog.at_level(logging.WARNING):
        got = pmesh.shard_batch_time(y, _port_mesh((2, 2), ("data", "seq"), (1, 1)), 2)
    np.testing.assert_array_equal(got.numpy(), y[2:])
    assert any("'seq' shards" in r.getMessage() for r in caplog.records)


def test_input_time_axis_matches_jax():
    for shape in [(2, 16, 40), (2, 40, 16), (2, 16)]:
        x = np.zeros(shape, np.float32)
        assert train_mod.input_time_axis(x, 16) == jax_train.input_time_axis(x, 16)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sampler_deals_jax_batches(world, shuffle):
    pre = synthetic.Preprocessor(None, num_features=16)
    ds = synthetic.Dataset(None, pre, split="train")
    for rank in range(world):
        ours = utils.BatchSortedSampler(ds, 8, rank, world, shuffle, seed=3)
        theirs = jax_utils.BatchSortedSampler(ds, 8, rank, world, shuffle, seed=3)
        assert len(ours) == len(theirs)
        for _ in range(2):  # two passes: the permutations follow one stream
            assert list(ours) == list(theirs)


def _config(tmp_path, **optim):
    config = {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 16},
        "model_type": "tds2d",
        "model": MODEL,
        "criterion_type": "ctc",
        "optim": dict({"batch_size": 8, "epochs": 1, "learning_rate": 0.02,
                       "step_size": 40, "max_grad_norm": 5}, **optim),
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return config, str(path)


def test_metrics_interval_decodes_every_kth_step(tmp_path, monkeypatch):
    config, cfg = _config(tmp_path, metrics_interval=3)
    made = []

    class Meters(utils.Meters):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(utils, "Meters", Meters)
    train_mod.train(train_mod.parse_args(
        ["--config", cfg, "--checkpoint_path", str(tmp_path), "--disable_cuda"]))
    train_meters = made[0]
    assert train_meters.num_samples == 64

    # the same steps, decoding steps 0, 3 and 6 only
    dataset, pre, crit, model, _ = train_mod.load_experiment(
        config, torch.Generator().manual_seed(0))
    train_mod.criterion_to_device(crit, torch.device("cpu"))
    step = train_mod.make_train_step(model, crit, 0.02, 0.02, 5)
    loader = utils.data_loader(dataset.Dataset(None, pre, split="train", augment=True),
                               config, seed=0)
    iter(loader.sampler)  # the batch order train draws as JAX's initialisation does
    want = utils.Meters()
    gen = torch.Generator().manual_seed(1)
    for i, (inputs, _, targets) in enumerate(loader):
        _, outputs = step(torch.from_numpy(inputs), crit.prepare(targets), gen, 1.0)
        if i % 3 == 0:
            want.add_decodes(crit.viterbi(outputs), targets, pre)
    assert want.num_tokens < sum(len(t) for t in
                                 dataset.Dataset(None, pre, split="train").texts)
    assert train_meters.num_tokens == want.num_tokens
    assert train_meters.edit_distance_tokens == want.edit_distance_tokens
    assert train_meters.edit_distance_words == want.edit_distance_words


def test_prepared_batches_on_a_thread_match_in_turn():
    """``train.prepared_batches`` yields each batch and its prepared
    targets; the background thread that ``scripts/time_prefetch.py`` times
    against it (JAX's) yields the same batches, and a loader's exception
    reaches the consumer of either."""
    class Crit:
        def prepare(self, targets):
            return [len(t) for t in targets]

    loader = [(np.full((2, 3), i, np.float32), [3, i], [[1] * i, [2]]) for i in range(5)]
    ahead = list(time_prefetch.threaded_batches(loader, Crit(), prefetch=2))
    in_turn = list(train_mod.prepared_batches(loader, Crit()))
    assert len(ahead) == len(in_turn) == 5
    for (inputs, widths, targets), a, b in zip(loader, ahead, in_turn):
        assert np.array_equal(a[0], inputs) and a[1:] == b[1:]
        assert b[3] == [len(t) for t in targets] and b[1] == widths

    def broken():
        yield loader[0]
        raise ValueError("bad sample")

    for batches in (time_prefetch.threaded_batches, train_mod.prepared_batches):
        with pytest.raises(ValueError, match="bad sample"):
            list(batches(broken(), Crit()))


def _jax_fused_case():
    model = FlaxTDS2d(input_size=16, output_size=6, **MODEL)
    K, B, W = 2, 4, 32
    rng = np.random.RandomState(0)
    x = rng.randn(K, B, 16, W).astype(np.float32)
    targets = [[list(rng.randint(0, 5, size=3)) for _ in range(B)] for _ in range(K)]
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    return model, x, targets, variables


def test_fused_steps_match_sequential_and_jax():
    flax_model, x, targets, variables = _jax_fused_case()
    K = x.shape[0]

    def port_model():
        return tds2d_from_flax(variables, TDS2d(input_size=16, output_size=6, **MODEL))

    crit = CTC(5)
    prep = [crit.prepare(t) for t in targets]
    # the targets of both batches share one padded shape: stack them
    prep_k = tuple(torch.stack([torch.as_tensor(p[i]) for p in prep]) for i in range(2))
    fused_model, seq_model = port_model(), port_model()
    old = [p.detach().double().clone() for p in fused_model.parameters()]
    fused = train_mod.make_fused_train_steps(fused_model, crit, 0.05, 0.05, 5.0, K)
    loss = fused(torch.from_numpy(x), prep_k, torch.Generator(), 1.0)
    step = train_mod.make_train_step(seq_model, crit, 0.05, 0.05, 5.0)
    losses = [step(torch.from_numpy(x[k]), prep[k], torch.Generator(), 1.0)[0]
              for k in range(K)]
    assert float(loss) == float(torch.stack(losses).mean())
    for a, b in zip(fused_model.parameters(), seq_model.parameters()):
        assert torch.equal(a, b)

    jcrit = JaxCTC(5)
    jprep = [jcrit.prepare(t) for t in targets]
    jprep_k = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jprep)
    jfused = jax_train.make_fused_train_steps(flax_model, jcrit, 0.05, 0.05, 5.0, K)
    jparams, jloss = jfused({"model": variables, "criterion": {}}, jnp.asarray(x), jprep_k,
                            jax.random.PRNGKey(7), 1.0)
    assert abs(float(loss) - float(jloss)) < 1e-4
    ref = tds2d_from_flax(jax.tree_util.tree_map(np.asarray, jparams["model"]),
                          TDS2d(input_size=16, output_size=6, **MODEL))
    names = [n for n, _ in fused_model.named_parameters()]
    total = _updates_match(old, [p.detach().double() for p in fused_model.parameters()],
                           [q.detach().double() for q in ref.parameters()], names)
    assert total > 0.05


def test_checkpoint_formats(tmp_path):
    model = torch.nn.Linear(3, 2)
    state = {"model": model.state_dict(), "criterion": {"transitions": torch.arange(4.0)},
             "epoch": 3, "num_updates": 7}
    for fmt in ("pickle", "orbax"):
        path = tmp_path / fmt
        utils.save_checkpoint(str(path), state, save_best=True, format=fmt)
        for last in (True, False):
            template = {"model": {k: torch.zeros_like(v) for k, v in state["model"].items()},
                        "criterion": {"transitions": torch.zeros(4)},
                        "epoch": 0, "num_updates": 0}
            got = utils.load_checkpoint(str(path), load_last=last, template=template)
            assert got["epoch"] == 3 and got["num_updates"] == 7
            for k, v in state["model"].items():
                assert torch.equal(got["model"][k], v)
            m, c = utils.load_from_checkpoint(str(path), last, template)
            assert torch.equal(c["transitions"], state["criterion"]["transitions"])
    assert (tmp_path / "orbax" / utils.DCP_DIR).is_dir()
    with pytest.raises(ValueError, match="template"):
        utils.load_checkpoint(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="format"):
        utils.save_checkpoint(str(tmp_path), state, format="other")
    mod = tmp_path / "extra_module.py"
    mod.write_text("VALUE = 41 + 1\n")
    assert utils.module_from_file("extra_module", str(mod)).VALUE == 42
    assert utils.round_up(17, 16) == 32


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_of_one_by_flags_restores_collective_checkpoint(tmp_path):
    """``main`` with ``--world_size 1 --coordinator_address`` joins a gloo
    group of one and destroys it after; its history is the plain run's.
    With ``checkpoint_format: "orbax"`` it writes the collective format,
    which ``--restore`` and ``test.py`` read."""
    _, cfg = _config(tmp_path, epochs=1, checkpoint_format="orbax")
    plain = train_mod.train(train_mod.parse_args(
        ["--config", cfg, "--checkpoint_path", str(tmp_path / "plain"), "--disable_cuda",
         "--profile_dir", str(tmp_path / "trace")]))[1]
    assert (tmp_path / "trace" / "trace_rank0.json").stat().st_size > 0
    flags = ["--world_size", "1", "--coordinator_address", f"127.0.0.1:{_free_port()}",
             "--process_id", "0"]
    ckpt = ["--checkpoint_path", str(tmp_path / "dist"), "--disable_cuda"]
    _, history = train_mod.main(["--config", cfg] + ckpt + flags)
    assert not torch.distributed.is_initialized()
    assert history == plain
    assert (tmp_path / "dist" / utils.DCP_DIR).is_dir()
    meters = test_mod.main(["--config", cfg, "--split", "test"] + ckpt)
    assert meters.num_samples == 16 and np.isfinite(meters.avg_loss)
    config, cfg = _config(tmp_path, epochs=2, checkpoint_format="orbax")
    _, more = train_mod.train(train_mod.parse_args(
        ["--config", cfg, "--restore", "--last_epoch", "1"] + ckpt))
    assert [h["epoch"] for h in more] == [2]


def test_seq_parallel_grid_raises_naming_a17(caplog):
    """Named for what it held before the sequence-parallel step was
    ported (a NotImplementedError naming ROADMAP A.17); it now holds the
    step's time shards: each rank of a 2 x 2 grid keeps its data rows (its
    own loader's) and ``train.shard_time`` its contiguous half of the
    frames, JAX's block on that device; the narrow TDS2d's shards of a
    width of 14 (7 frames, stride 2) do not fit, so time stays whole."""
    assert not hasattr(train_mod, "check_seq_parallel")
    x = np.arange(4 * 16 * 16, dtype=np.float32).reshape(4, 16, 16)
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    jmesh = JaxMesh(devices, ("data", "seq"))
    arr = jax_train.shard_batch(x, jmesh, jax_train.input_time_axis(x, 16))
    where = {d.id: idx for idx, d in np.ndenumerate(jmesh.devices)}
    model = TDS2d(input_size=16, output_size=5, **MODEL)
    for shard in arr.addressable_shards:
        d, s = where[shard.device.id]
        mesh = _port_mesh((2, 2), ("data", "seq"), (d, s))
        rows = torch.from_numpy(x[2 * d:2 * d + 2])
        got, axis = train_mod.shard_time(train_mod.shard_batch(rows, mesh, 2), mesh, 2, model)
        assert axis == 2
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    y = torch.from_numpy(x[:2, :, :14])
    pmesh._warned_indivisible.discard(("seq", 14, 2))
    with caplog.at_level(logging.WARNING):
        got, axis = train_mod.shard_time(y, _port_mesh((2, 2), ("data", "seq"), (0, 1)), 2,
                                         model)
    assert axis is None and got is y
    assert any("keeping time whole" in r.getMessage() for r in caplog.records)
