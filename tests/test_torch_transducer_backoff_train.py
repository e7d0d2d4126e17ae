"""train.py + test.py end to end on the CPU with the loaded backoff-LM
Transducer (``configs/iamdb/pruned_ngram_ctc.json``'s criterion and
optimiser sections) and a transitions file: the recipe's grapheme trigram,
and an unpruned 4-gram whose decode runs the per-step path.  The rest of
the criterion's checks against JAX: ``test_torch_transducer_backoff.py``.
"""

import json

import numpy as np

from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
from gtn_applications_tpu_torch.scripts import build_transitions as bt
from gtn_applications_tpu_torch.wfst import compile as wcompile
from gtn_applications_tpu_torch.wfst import graph as wgraph

from tests.test_torch_train import MODEL
from tests.test_torch_transducer_backoff import _texts


def _train_then_test(tmp_path, g):
    """train.py then test.py (--disable_cuda) with pruned_ngram_ctc.json's
    criterion and optimiser sections, its transitions ``g`` from a file, on
    a small TDS2d and the synthetic lines; the trained transitions are
    saved and restored."""
    path = tmp_path / "lm.bin"
    wgraph.save(path, g)
    with open("configs/iamdb/pruned_ngram_ctc.json") as fid:
        base = json.load(fid)
    config = {
        "seed": 0, "data": {"dataset": "synthetic", "num_features": 16},
        "model_type": "tds2d", "model": MODEL, "criterion_type": "transducer",
        "criterion": dict(base["criterion"], transitions=str(path)),
        "optim": dict(base["optim"], epochs=1, batch_size=32),
    }
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    ckpt = ["--config", str(cfg), "--checkpoint_path", str(tmp_path), "--disable_cuda"]
    _, history = train_mod.train(train_mod.parse_args(ckpt))
    assert np.isfinite(history[-1]["train_loss"]) and np.isfinite(history[-1]["val_loss"])
    state = utils.load_checkpoint(str(tmp_path), load_last=True)
    assert float(state["criterion"]["transitions"].abs().sum()) > 0
    meters = test_mod.run_test(test_mod.parse_args(ckpt + ["--split", "test"]))
    assert meters.num_samples == 16 and np.isfinite(meters.avg_loss)


def test_pruned_ngram_ctc_train_then_test_cpu(tmp_path):
    """The recipe's grapheme trigram over the synthetic train texts."""
    pre, texts = _texts()
    _train_then_test(tmp_path, bt.grapheme_lm(texts, pre.tokens))


def test_4gram_train_then_test_cpu(tmp_path):
    """An unpruned grapheme 4-gram over 16 synthetic train texts (S=432,
    A=11,077 after epsilon removal), whose decode table the whole-scan
    plan refuses: every decode of the run takes the per-step path."""
    pre, texts = _texts()
    g = bt.grapheme_lm(texts[:16], pre.tokens, (0, 0, 0, 0))
    table = wcompile.apply_decode_weights(wcompile.build_decode_template(g),
                                          np.zeros(g.num_arcs(), np.float32))
    assert vsp.build_plan(table) is None
    _train_then_test(tmp_path, g)
