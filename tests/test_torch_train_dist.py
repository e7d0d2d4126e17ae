"""``train.py`` and ``test.py`` of the port on two gloo ranks.

One spawn of two ranks (workers in ``tests/torch_dist_workers.py``, which
import no JAX) trains ``configs/synthetic/tds2d_ctc.json``'s model for 2
epochs (64 training lines, global batch 8: 4 a rank, train CER every
third step) with the collective checkpoint format, then evaluates the test
split with ``test.py`` on both ranks.  Its history (train loss and CER,
validation loss, CER and WER each epoch) equals the one-process run's: the
sampler deals each global batch's rows to the ranks, the step reduces the
gradient of the global batch's loss, and ``Meters.sync`` sums the counts.
Losses within rtol 1e-5 (the ranks sum the gradient in another order),
error rates exactly.  The same spawn then trains 2 epochs with
``optim.seq_parallel: 2`` on the world of two, a ``('data', 'seq')`` grid
of 1 x 2: each rank holds half of each batch's frames through the TDS2d
(every batch's padded width splits into shards that its strides and
halos allow); its history, and ``test.py``'s meters on the same grid,
equal the one-process run's at the same tolerances.
"""

import json
import os

import numpy as np
import pytest
import torch

from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.parallel import mesh as pmesh

from tests import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores, and a CPU train loop with a thread per core each slows ~70x
    under that contention (as in ``tests/test_torch_ctc_long.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, name, **optim):
    with open(os.path.join(ROOT, "configs", "synthetic", "tds2d_ctc.json")) as fid:
        config = json.load(fid)
    config["data"].pop("data_path")
    config["optim"].update(metrics_interval=3, **optim)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(config))
    return str(path)


def _argv(cfg, ckpt):
    return (["--config", cfg, "--checkpoint_path", str(ckpt), "--disable_cuda"],
            ["--config", cfg, "--checkpoint_path", str(ckpt), "--disable_cuda",
             "--split", "test"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_dist")
    one = _config(tmp, "one")
    train_argv, test_argv = _argv(one, tmp / "one")
    _, history = train_mod.train(train_mod.parse_args(train_argv))
    meters = test_mod.run_test(test_mod.parse_args(test_argv))
    single = {"history": history, "test": [meters.avg_loss, meters.cer, meters.wer,
                                           meters.num_samples]}
    two = _config(tmp, "two", checkpoint_format="orbax")
    seq = _config(tmp, "seq", seq_parallel=2)
    ranks = pmesh.spawn(workers.train_ranks, N,
                        args=(*_argv(two, tmp / "two"), *_argv(seq, tmp / "seq")),
                        timeout=600)
    return single, ranks, tmp


def test_two_ranks_train_like_one(runs):
    single, ranks, _ = runs
    for r in ranks:
        assert len(r["history"]) == 2
        for got, want in zip(r["history"], single["history"]):
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
            for key in ("epoch", "train_cer", "val_cer", "val_wer"):
                assert got[key] == want[key], key


def test_two_ranks_test_split_like_one(runs):
    single, ranks, tmp = runs
    assert (tmp / "two" / "model.dcp").is_dir()
    loss, cer, wer, n = single["test"]
    for r in ranks:
        np.testing.assert_allclose(r["test"][0], loss, rtol=1e-5)
        assert r["test"][1:3] == [cer, wer]
        assert r["test"][3] == N * n  # every rank evaluated the whole split


def test_seq_parallel_on_two_ranks_raises(runs):
    """Named for what it held before the sequence-parallel step was
    ported (a NotImplementedError); it now holds that step's training and
    ``test.py`` on the seq grid."""
    single, ranks, _ = runs
    loss, cer, wer, n = single["test"]
    for r in ranks:
        # 8 train and 2 validation batches an epoch, 2 test batches
        assert r["seq_batches"] == [22, 0]
        assert len(r["seq"]["history"]) == 2
        for got, want in zip(r["seq"]["history"], single["history"]):
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
            for key in ("epoch", "train_cer", "val_cer", "val_wer"):
                assert got[key] == want[key], key
        np.testing.assert_allclose(r["seq"]["test"][0], loss, rtol=1e-5)
        # each rank counts each sample once: the 'data' group is the rank alone
        assert r["seq"]["test"][1:] == [cer, wer, n]
