"""The word-decomposition, IAM word and WSJ recipes at small widths,
against the JAX package on the CPU.

For each of ``configs/iamdb/word_decomps.json``, ``librispeech/word_decomps.json``,
``wsj/word_decomps.json`` (the word-decomposition Transducer: no
transitions, the dense scan), ``iamdb/tds2d_words.json`` and ``wsj/tds.json``
(CTC), cut to two channels and one block a group with dropout 0 (strides,
kernels, depth, blanks, repeats, ``prepend_wordsep`` and the optimiser's
settings as shipped) and read on the synthetic data (glyph lines, of 48
px glyphs at the word decompositions' time stride of 16; tones of 320 ms a
character for the speech configs: every line has frames to spare for its
targets, whose infeasible gradients the routes define apart) with a
48-piece inventory that the port's ``make_wordpieces`` writes from the
synthetic corpus.  JAX's Transducer takes its dense transitions-free route
(``_FACTORED_IMPL`` on, as on the TPU; the port takes it on every device):

- the port's ``train.load_experiment`` and JAX's build a model of the same
  parameter shapes (Flax's weights load into the port's through
  ``tds2d_from_flax`` / ``tds_from_flax``) and criteria of the same
  outputs, whose ``prepare`` of the batch gives equal host tables;
- one SGD step of each package's ``make_train_step`` (JAX's jitted) on one
  batch of 8 samples: the loss within 1e-4 relative, each parameter's
  update within 1e-3 of its norm (floored at 1e-3 of the whole update's
  norm, ``tests/test_torch_train.py``'s rule);
- ``test.py``'s decode of the batch through each updated model
  (``criterion.viterbi``, then ``to_text``) equal to JAX's.

The WSJ configs run only here: on the card the smoke runs their LibriSpeech
twins, which differ from them only in batch, learning rate, dropout and
file names.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.datasets import synthetic, synthetic_audio
from gtn_applications_tpu_torch.models.convert import tds2d_from_flax, tds_from_flax
from gtn_applications_tpu_torch.scripts import make_wordpieces, wordpiece

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["iamdb/word_decomps", "librispeech/word_decomps", "wsj/word_decomps",
           "iamdb/tds2d_words", "wsj/tds"]
PIECES = 48
BATCH = 8
GLYPH_W = 48  # px a glyph of the word decompositions' lines
CHAR_MS = 320  # ms a character of the speech configs' tones


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    """The token and lexicon files of a 48-piece inventory over the
    synthetic corpus, its vocabulary the synthetic splits' words."""
    out = tmp_path_factory.mktemp("pieces")
    pre = synthetic.Preprocessor(None, num_features=8)
    vocab = sorted({w for split in ("train", "validation", "test")
                    for text in synthetic.Dataset(None, pre, split=split).texts
                    for w in text.split("▁")}
                   | {w for split in ("train", "validation", "test")
                      for text in synthetic_audio.Dataset(None, synthetic_audio.Preprocessor(
                          None, num_features=8), split=split).texts
                      for w in text.split("▁")})
    model = wordpiece.train_unigram(synthetic._make_corpus(400, 11), PIECES)
    make_wordpieces.save_pieces(model, PIECES, str(out / "wp"), vocab)
    return out


def _config(name, pieces):
    """The shipped config cut to narrow widths on synthetic data."""
    with open(ROOT / "configs" / f"{name}.json") as fid:
        config = json.load(fid)
    data = config["data"]
    data["dataset"] = "synthetic" if name.startswith("iamdb") else "synthetic_audio"
    for key, kind in (("tokens", "tokens"), ("lexicon", "lex")):
        if key in data:
            data[key] = str(pieces / f"wp_{kind}_{PIECES}.txt")
    for group in config["model"]["tds_groups"]:
        group.update(channels=2, num_blocks=1)
    config["model"]["dropout"] = 0.0
    return config


def _batch(config, pre):
    """The first BATCH samples of the train split (glyph lines, of GLYPH_W
    px glyphs for the word decompositions; tones of CHAR_MS a character)."""
    if config["data"]["dataset"] == "synthetic":
        wide = config.get("criterion_type") == "transducer"
        ds = synthetic.Dataset(None, pre, split="train",
                               **({"glyph_w": GLYPH_W} if wide else {}))
    else:
        ds = synthetic_audio.Dataset(None, pre, split="train")
    inputs, _, targets = utils.padding_collate([ds[i] for i in range(BATCH)])
    return inputs, targets


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _prepared_tables(prepared):
    """The host tables of a criterion's ``prepare`` (CTC: targets and
    lengths; the Transducer: its dense tables), as numpy arrays by name."""
    if isinstance(prepared, dict):
        f = prepared["factored"]
        return {k: np.asarray(f[k]) for k in ("adj_exp", "lab_oh", "start", "accept")}
    return {f"prepared_{i}": np.asarray(x) for i, x in enumerate(prepared)}


@pytest.mark.parametrize("name", CONFIGS)
def test_recipe_matches_jax(name, pieces, monkeypatch):
    monkeypatch.setattr(jax_td, "_FACTORED_IMPL", "on")
    monkeypatch.setattr(synthetic_audio, "_CHAR_MS", CHAR_MS)
    config = _config(name, pieces)
    optim = config["optim"]
    lr, max_grad_norm = optim["learning_rate"], optim["max_grad_norm"]
    _, pre, crit, model, input_size = train_mod.load_experiment(config)
    _, jpre, jcrit, jmodel, j_input_size = jax_train.load_experiment(config)
    assert (input_size, pre.num_tokens) == (j_input_size, jpre.num_tokens)
    assert input_size == config["data"]["num_features"]
    assert ("tokens" in config["data"]) == (pre.num_tokens == PIECES)
    inputs, targets = _batch(config, pre)
    _, j_targets = _batch(config, jpre)
    assert [list(t) for t in targets] == [list(t) for t in j_targets]

    variables = _as_numpy(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(inputs)))
    convert = tds2d_from_flax if config["model_type"] == "tds2d" else tds_from_flax
    convert(variables, model)
    n_out = model(torch.from_numpy(inputs[:1])).shape[-1]
    assert n_out == jmodel.apply(variables, jnp.asarray(inputs[:1])).shape[-1]
    if config.get("criterion_type") == "transducer":
        assert crit.num_channels == n_out == PIECES + 1
        assert crit.transitions is None and jcrit.transitions is None
    prepared, j_prepared = crit.prepare(targets), jcrit.prepare(targets)
    tables, j_tables = _prepared_tables(prepared), _prepared_tables(j_prepared)
    assert tables.keys() == j_tables.keys()
    for key in tables:
        np.testing.assert_array_equal(tables[key], j_tables[key], err_msg=key)

    params = list(model.parameters())
    old = [p.detach().double().clone() for p in params]
    step = train_mod.make_train_step(model, crit, lr, lr, max_grad_norm)
    loss, _ = step(torch.from_numpy(inputs), prepared, torch.Generator(), 1.0)
    jstep = jax_train.make_train_step(jmodel, jcrit, lr, lr, max_grad_norm)
    j_params, j_loss, _ = jstep({"model": variables, "criterion": {}}, jnp.asarray(inputs),
                                j_prepared, jax.random.PRNGKey(1), jnp.float32(1.0))
    assert float(loss) < 1e3  # every sample's target fits in its frames
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)

    ref = convert(_as_numpy(j_params["model"]), train_mod.load_experiment(config)[3])
    d_port = [p.detach().double() - o for p, o in zip(params, old)]
    d_jax = [q.detach().double() - o for q, o in zip(ref.parameters(), old)]
    total = float(torch.sqrt(sum((d ** 2).sum() for d in d_jax)))
    assert total > 1e-3
    for (pname, _), dp, dj in zip(model.named_parameters(), d_port, d_jax):
        scale = max(float(dj.norm()), 1e-3 * total)
        assert float((dp - dj).norm()) <= 1e-3 * scale, pname

    model.eval()
    with torch.no_grad():
        outputs = model(torch.from_numpy(inputs))
    j_outputs = jmodel.apply(j_params["model"], jnp.asarray(inputs))
    preds = [pre.tokens_to_text(p) for p in crit.viterbi(outputs)]
    j_preds = [jpre.tokens_to_text(p) for p in jcrit.viterbi(j_outputs)]
    assert preds == j_preds
