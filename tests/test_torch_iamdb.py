"""The port's IAM dataset against the JAX package's, on a fixture tree.

The IAM images are license-gated, so the tree is the one
``tests/test_datasets.py`` builds (two forms, random 1100 x 2100 pages,
two train lines, one validation and one test line), plus a ``words.txt``
with an ``err`` word.  Both packages run the same numpy and PIL code, so
every comparison is exact: the metadata, the preprocessor's tokens and
indices (lines and words), ``sample_sizes``, every sample with and
without augmentation under one ``random.seed``, ``fast_pipeline``'s
batches, and the CLI's report and exports.  Then ``load_experiment``
resolves ``configs/iamdb/{tds2d,rnn,tds}.json`` on the tree, and one
``--disable_cuda`` training epoch of a narrow TDS2d reads it.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu.datasets import iamdb as jax_iamdb
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.criterions import CTC
from gtn_applications_tpu_torch.datasets import iamdb
from gtn_applications_tpu_torch.models import RNN, TDS, TDS2d

from tests.test_datasets import _make_iam_fixture

WORDS = [
    "# comment line",
    "a01-000u-00-00 ok 154 408 746 242 89 DT A",
    "a01-000u-00-01 ok 154 700 746 400 89 NN MOVE",
    "a01-000u-01-00 err 156 395 932 300 105 AT the",
    "a01-000u-01-01 ok 156 800 932 500 105 NN train",
    "a02-000-00-00 ok 150 300 500 400 80 UH hello",
    "a02-000-01-00 ok 151 310 510 350 75 RB again",
]


@pytest.fixture(scope="module")
def iam_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("iam"))
    assert _make_iam_fixture(root)  # PIL is installed here
    with open(os.path.join(root, "words.txt"), "w") as fid:
        fid.write("\n".join(WORDS) + "\n")
    return root


def _pair(root, use_words, **kw):
    """(port, JAX) datasets of every split and their preprocessors."""
    pre = iamdb.Preprocessor(root, 32, use_words=use_words)
    jpre = jax_iamdb.Preprocessor(root, 32, use_words=use_words)
    splits = {s: (iamdb.Dataset(root, pre, s, **kw), jax_iamdb.Dataset(root, jpre, s, **kw))
              for s in ("train", "validation", "test")}
    return pre, jpre, splits


@pytest.mark.parametrize("use_words", [False, True])
def test_metadata_preprocessor_and_sizes_match_jax(iam_root, use_words):
    forms = iamdb.load_metadata(iam_root, use_words=use_words)
    assert forms == jax_iamdb.load_metadata(iam_root, use_words=use_words)
    assert sum(len(f) for f in forms.values()) == (5 if use_words else 4)  # no err word
    pre, jpre, splits = _pair(iam_root, use_words)
    assert pre.use_words == use_words
    assert pre.tokens == jpre.tokens and pre.graphemes == jpre.graphemes
    for form in forms.values():
        for line in form:
            np.testing.assert_array_equal(pre.to_index(line["text"]),
                                          jpre.to_index(line["text"]))
    for name, (ds, jds) in splits.items():
        assert len(ds) == len(jds) > 0, name
        assert ds.sample_sizes() == jds.sample_sizes(), name


@pytest.mark.parametrize("augment", [False, True])
def test_samples_match_jax(iam_root, augment):
    _, _, splits = _pair(iam_root, False, augment=augment)
    for ds, jds in splits.values():
        for i in range(len(ds)):
            random.seed(i)
            x, y = ds[i]
            random.seed(i)
            jx, jy = jds[i]
            assert x.dtype == np.float32 and x.shape[0] == 32
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("augment", [False, True])
def test_fast_pipeline_batches_match_jax(iam_root, augment):
    """The port's loader takes the dataset's ``collate_fn``; each batch of
    ``fast_pipeline`` equals JAX's ``_collate_fast`` on the same samples,
    and without augmentation the default pipeline's padded batch."""
    _, _, splits = _pair(iam_root, False, augment=augment, fast_pipeline=True)
    ds, jds = splits["train"]
    config = {"data": {}, "optim": {"batch_size": 2}}
    loader = utils.data_loader(ds, config)
    assert loader.collate_fn == ds.collate_fn
    # a subset (``num_samples``) forwards the dataset's collate
    sub = {"data": {"num_samples": 1}, "optim": {"batch_size": 2}}
    assert utils.data_loader(ds, sub).collate_fn == ds.collate_fn
    random.seed(3)
    (x, widths, targets), = list(loader)
    order = loader.sampler.batches[0]
    random.seed(3)
    jx, jwidths, jtargets = jds._collate_fast([jds[i] for i in order])
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(widths, jwidths)
    assert len(targets) == len(jtargets) == 2
    for t, jt in zip(targets, jtargets):
        np.testing.assert_array_equal(t, jt)
    if not augment:
        plain = iamdb.Dataset(iam_root, ds.preprocessor, "train")
        px, pwidths, _ = utils.padding_collate([plain[i] for i in order])
        np.testing.assert_allclose(x, px, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(widths, pwidths)


def test_cli_matches_jax(iam_root, tmp_path, capsys):
    outs = []
    for name, cli in (("port", iamdb._cli), ("jax", jax_iamdb._cli)):
        text, tokens = tmp_path / f"{name}.txt", tmp_path / f"{name}.tok"
        cli(["--data_path", iam_root, "--save_text", str(text),
             "--save_tokens", str(tokens), "--compute_stats"])
        outs.append((capsys.readouterr().out, text.read_text(), tokens.read_text()))
    assert outs[0] == outs[1]
    assert "split sizes: train=2, validation=1, test=1" in outs[0][0]


@pytest.mark.parametrize("name,model_cls", [
    ("tds2d", TDS2d), ("rnn", RNN), ("tds", TDS)])
def test_load_experiment_resolves_iamdb_configs(iam_root, name, model_cls):
    with open(f"configs/iamdb/{name}.json") as fid:
        config = json.load(fid)
    config["data"]["data_path"] = iam_root
    dataset, pre, crit, model, input_size = train_mod.load_experiment(
        config, torch.Generator().manual_seed(0))
    _, jpre, jcrit, jmodel, _ = jax_train.load_experiment(config)
    assert dataset is iamdb and input_size == 64
    assert isinstance(model, model_cls) and isinstance(crit, CTC)
    assert pre.tokens == jpre.tokens
    assert model.linear.out_features == jmodel.output_size == pre.num_tokens + 1
    assert model.time_stride == jmodel.time_stride


def test_train_epoch_on_iamdb_cpu(iam_root, tmp_path):
    """One epoch (one step of two lines, then the validation line) of a
    narrow TDS2d with CTC on the fixture, through train.py on the CPU, and
    test.py on the test line."""
    config = {
        "seed": 0,
        "data": {"dataset": "iamdb", "data_path": iam_root, "num_features": 32,
                 "fast_pipeline": True},
        "model_type": "tds2d",
        "model": {"depth": 2, "dropout": 0.1, "kernel_size": [3, 5],
                  "tds_groups": [{"channels": 2, "num_blocks": 1, "stride": [2, 2]},
                                 {"channels": 4, "num_blocks": 1, "stride": [2, 2]}]},
        "criterion_type": "ctc",
        "optim": {"batch_size": 2, "epochs": 1, "learning_rate": 0.1,
                  "step_size": 100, "max_grad_norm": 5},
    }
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    model, history = train_mod.train(train_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(tmp_path), "--disable_cuda"]))
    assert isinstance(model, TDS2d)
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["val_loss"])
    assert os.path.exists(tmp_path / "model.checkpoint")
    meters = test_mod.run_test(test_mod.parse_args(
        ["--config", str(cfg), "--checkpoint_path", str(tmp_path), "--disable_cuda"]))
    assert meters.num_samples == 1 and np.isfinite(meters.avg_loss)
