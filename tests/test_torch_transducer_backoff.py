"""The loaded backoff-LM Transducer of the port against the JAX package.

``configs/iamdb/pruned_ngram_ctc.json`` loads a pruned backoff n-gram
transition graph (epsilon backoff arcs) built by
``scripts/build_transitions.py``; the Transducer composes it into each
target's lattice (the composed path) and scores it against the transition
graph alone.  Held to JAX here:

  * the graph files: the binary ``save``/``load`` in both directions, byte
    for byte, and ``loadtxt``/``savetxt`` on the reference's backoff
    fixture ``tests/goldens/trans_backoff_test.txt``;
  * the builder copy: the same arcs as the JAX builder on the synthetic
    corpus, at the recipe's settings and others;
  * ``prepare``'s composed tables and weight provenance, exactly;
  * the loss and its gradients to the logits and the transitions, on the
    fixture, the grapheme trigram, ``ngram=3`` and a built bigram, through
    the plain route and the kernels' route (their plain versions here) of
    the composed path, and through the backoff factorings
    (``GTN_TRANSDUCER_FACTORED=on`` on both sides; the bigram's dense
    variant refused, so that it takes the dst one): loss rtol 1e-5 + atol
    1e-5, gradients rtol 1e-4 + atol 1e-6; and a numeric-gradient check of
    the transitions (as ``tests/test_transducer.py`` checks JAX's);
  * the decode template and ``Transducer.viterbi`` on a backoff graph,
    labels exactly; on the unpruned grapheme 4-gram over the long-line
    texts, whose decode table the whole-scan plan refuses (the per-step
    ``seg_max`` decode), outputs exactly; on a 200-token bigram (S_c * N
    past 2^15: the destination-factored decode), labels exactly; and
    ``blank="forced"`` decoding (the native ``forced_collapse``),
    infeasible alignments decoding to nothing;
  * one SGD step of a narrow TDS2d with this criterion, composed and
    through the dense factoring (loss 1e-4, each update within 1e-3 of its
    norm).

train.py + test.py end to end on the CPU with a transitions file (the
trigram, and a 4-gram whose decode runs the per-step path):
``test_torch_transducer_backoff_train.py``.  The backoff factorings
function by function: ``test_torch_factored_backoff.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu import wfst as jax_wfst
from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu.datasets import synthetic_long as jax_long
from gtn_applications_tpu.ops import viterbi_scan_pallas as jax_vsp
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu.scripts import build_transitions as jax_bt
from gtn_applications_tpu.wfst import compile as jax_wcompile
from gtn_applications_tpu_torch import profile_step, utils
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.criterions import transducer as td
from gtn_applications_tpu_torch.datasets import synthetic, synthetic_long
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import (
    criterion_params_from_jax, tds2d_from_flax,
)
from gtn_applications_tpu_torch.ops import sparse
from gtn_applications_tpu_torch.ops import viterbi_scan_pallas as vsp
from gtn_applications_tpu_torch.scripts import build_transitions as bt
from gtn_applications_tpu_torch.wfst import compile as wcompile
from gtn_applications_tpu_torch.wfst import graph as wgraph

from tests.test_torch_train import MODEL, _updates_match

FIXTURE = "tests/goldens/trans_backoff_test.txt"
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TABLE_FIELDS = ("src", "dst", "label", "weight", "start", "accept", "eps_src",
                "eps_dst", "eps_weight")


def _same_graph(g, jg):
    assert g.start == jg.start
    assert g.finals == jg.finals
    for f in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
        assert getattr(g, f) == getattr(jg, f), f


def _weighted_fixture(module):
    g = module.loadtxt(FIXTURE)
    g.set_weights(np.random.RandomState(0).randn(g.num_arcs()).astype(np.float32).tolist())
    g.add_final(3, 0.25)  # a second way of accepting at node 3
    return g


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_graph_files_round_trip_with_jax(writer, tmp_path):
    path = tmp_path / "g.bin"
    (wgraph if writer == "port" else jax_wfst).save(path, _weighted_fixture(
        wgraph if writer == "port" else jax_wfst))
    _same_graph(wgraph.load(path), jax_wfst.load(path))
    other = tmp_path / "other.bin"
    (jax_wfst if writer == "port" else wgraph).save(other, _weighted_fixture(
        jax_wfst if writer == "port" else wgraph))
    assert path.read_bytes() == other.read_bytes()


def test_text_files_match_jax(tmp_path):
    g, jg = wgraph.loadtxt(FIXTURE), jax_wfst.loadtxt(FIXTURE)
    _same_graph(g, jg)
    assert g.num_arcs() == 37 and g.num_nodes() == 8
    wgraph.savetxt(tmp_path / "port.txt", g)
    jax_wfst.savetxt(tmp_path / "jax.txt", jg)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    _same_graph(wgraph.loadtxt(tmp_path / "jax.txt"), g)
    copy = g.copy()
    copy.arc_weight[0] = 5.0
    assert g.arc_weight[0] == 0.0


def _texts(long=False):
    module = synthetic_long if long else synthetic
    pre = module.Preprocessor(None, num_features=16)
    return pre, module.Dataset(None, pre, split="train").texts


@pytest.mark.parametrize("prune,blank,self_loops,long", [
    ((0, 5, 10), "optional", False, True),  # the IAM recipe's settings
    ((0, 5, 10), "optional", False, False),
    ((0, 2), "forced", False, False),
    ((0, 0), "none", True, False),
])
def test_builder_matches_jax(prune, blank, self_loops, long):
    pre, texts = _texts(long)
    lines = [list(t) for t in texts]
    g = bt.build_from_lines(lines, pre.tokens, list(prune), blank, self_loops)
    t2i = {t: i for i, t in enumerate(pre.tokens)}
    kept = jax_bt.prune_ngrams(jax_bt.count_ngrams(lines, len(prune), t2i), list(prune))
    if blank != "none":
        kept = jax_bt.add_blank_grams(kept, len(t2i), blank)
    if self_loops:
        kept = jax_bt.add_self_loops(kept)
    _same_graph(g, jax_bt.build_graph(kept))
    if blank == "optional" and long:
        _same_graph(bt.grapheme_lm(texts, pre.tokens), jax_bt.build_graph(kept))


def test_builder_cli_writes_the_jax_file(tmp_path):
    pre, texts = _texts()
    (tmp_path / "train.txt").write_text("\n".join(texts) + "\n")
    (tmp_path / "tokens.txt").write_text("\n".join(pre.tokens) + "\n")
    args = ["--data_path", str(tmp_path / "train.txt"), "--tokens",
            str(tmp_path / "tokens.txt"), "--prune", "0", "5", "10", "--blank", "optional"]
    bt.main(args + ["--save_path", str(tmp_path / "port.bin")])
    jax_bt.main(args + ["--save_path", str(tmp_path / "jax.bin")])
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def _fixture_pair(n=5):
    kw = dict(blank="optional", allow_repeats=False, reduction="mean")
    args = ([(i,) for i in range(n)], {i: i for i in range(n)})
    return (td.Transducer(*args, transitions=wgraph.loadtxt(FIXTURE), **kw),
            jax_td.Transducer(*args, transitions=jax_wfst.loadtxt(FIXTURE), **kw))


def _trigram_pair():
    pre, texts = _texts()
    kw = dict(blank="optional", allow_repeats=False, reduction="mean")
    g = bt.grapheme_lm(texts, pre.tokens)
    jg = jax_bt.build_graph(jax_bt.add_blank_grams(jax_bt.prune_ngrams(
        jax_bt.count_ngrams([list(t) for t in texts], 3,
                            {t: i for i, t in enumerate(pre.tokens)}), [0, 5, 10]),
        len(pre.tokens), "optional"))
    return (td.Transducer(pre.tokens, pre.graphemes_to_index, transitions=g, **kw),
            jax_td.Transducer(pre.tokens, pre.graphemes_to_index, transitions=jg, **kw))


def _ngram3_pair():
    kw = dict(ngram=3, blank="optional", allow_repeats=False, reduction="mean")
    args = ([(i,) for i in range(3)], {i: i for i in range(3)})
    return td.Transducer(*args, **kw), jax_td.Transducer(*args, **kw)


def _bigram_dst_pair(ntok=4):
    """A pruned bigram with blanks and self-loops by ``build_transitions``,
    its dense variant refused on both sides (as for a 1k-wordpiece LM), so
    that the factored route takes the destination-factored one."""
    rng = np.random.RandomState(8)
    lines = [[str(i) for i in rng.randint(0, ntok, rng.randint(3, 9))] for _ in range(150)]
    toks = [str(i) for i in range(ntok)]
    t2i = {t: i for i, t in enumerate(toks)}
    g = bt.build_from_lines(lines, toks, [0, 0], "optional", self_loops=True)
    jg = jax_bt.build_graph(jax_bt.add_self_loops(jax_bt.add_blank_grams(
        jax_bt.prune_ngrams(jax_bt.count_ngrams(lines, 2, t2i), [0, 0]), ntok, "optional")))
    kw = dict(blank="optional", reduction="mean")
    pair = td.Transducer(toks, t2i, transitions=g, **kw), jax_td.Transducer(
        toks, t2i, transitions=jg, **kw)
    for crit in pair:
        assert crit._factored_backoff_dst
        crit._factored_backoff = False
    return pair


CASES = {"fixture": _fixture_pair, "trigram": _trigram_pair, "ngram3": _ngram3_pair,
         "bigram_dst": _bigram_dst_pair}


def _targets(name, rng, B=4):
    if name == "trigram":
        pre, _ = _texts()
        ds = synthetic.Dataset(None, pre, split="train")
        return [ds[i][1].tolist() for i in range(B)], 48
    n = {"fixture": 5, "bigram_dst": 4}.get(name, 3)
    return [rng.randint(0, n, size=rng.randint(1, 4)).tolist() for _ in range(B)], 9


@pytest.mark.parametrize("name", list(CASES))
def test_composed_prepare_matches_jax(name):
    crit, jcrit = CASES[name]()
    assert crit.num_transition_arcs == jcrit.num_transition_arcs
    targets, _ = _targets(name, np.random.RandomState(1))
    prep, jprep = crit.prepare(targets), jcrit.prepare(targets)
    assert "table" in prep and "table" in jprep
    for f in TABLE_FIELDS:
        a, b = getattr(prep["table"], f).numpy(), np.asarray(getattr(jprep["table"], f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert prep["table"].eps_depth == jprep["table"].eps_depth
    for key in ("widx", "eps_widx", "target_lengths"):
        np.testing.assert_array_equal(prep[key].numpy(), np.asarray(jprep[key]),
                                      err_msg=key)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(crit._norm_table, f).numpy(),
                                      np.asarray(getattr(jcrit._norm_table, f)), err_msg=f)
    np.testing.assert_array_equal(crit._norm_widx.numpy(), jcrit._norm_widx)
    np.testing.assert_array_equal(crit._norm_eps_widx.numpy(), jcrit._norm_eps_widx)
    assert crit._factored_backoff == jcrit._factored_backoff
    assert crit._factored_backoff_dst == jcrit._factored_backoff_dst


@pytest.mark.parametrize("route", ["plain", "kernels", "factored"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name, route, monkeypatch):
    """Composed (the plain route, or the kernels' with their plain versions
    standing in), or through the backoff factorings with
    ``GTN_TRANSDUCER_FACTORED=on`` on both sides: the dense variant for the
    fixture, the trigram and ngram=3, the dst variant for the bigram."""
    if route == "kernels":
        monkeypatch.setattr(sparse, "forward_score_batch_tables",
                            sparse._forward_batched_kernels)
    if route == "factored":
        monkeypatch.setattr(td, "_FACTORED_IMPL", "on")
        monkeypatch.setattr(jax_td, "_FACTORED_IMPL", "on")
    crit, jcrit = CASES[name]()
    rng = np.random.RandomState(2)
    targets, T = _targets(name, rng)
    B, N = len(targets), crit.num_channels
    x = rng.randn(B, T, N).astype(np.float32)
    lens = np.asarray([T, T - 1, T - 3, T], np.int32)
    trans = (rng.randn(crit.num_transition_arcs) * 0.3).astype(np.float32)

    jprep, prep = jcrit.prepare(targets), crit.prepare(targets)
    assert sorted(prep) == sorted(jprep)
    assert ("factored" in prep) == (route == "factored")
    assert ("factored_dst" in prep) == (route == "factored" and name == "bigram_dst")
    j_loss, (j_gp, j_gx) = jax.value_and_grad(
        lambda p, x: jcrit.loss({"transitions": p}, x, jprep, jnp.asarray(lens)),
        argnums=(0, 1))(jnp.asarray(trans), jnp.asarray(x))
    p_t = torch.from_numpy(trans).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss({"transitions": p_t}, x_t, prep, torch.from_numpy(lens))
    gx, gp = torch.autograd.grad(loss, [x_t, p_t])
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), err_msg="logits", **GRAD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(j_gp), err_msg="transitions",
                               **GRAD_TOL)


def test_backoff_fixture_numeric_gradient():
    """The port's form of ``tests/test_transducer.py``'s backoff-fixture
    check: the transitions gradient against central differences over every
    arc (T=4, labels [0, 1, 0], optional blank, no repeats)."""
    crit, _ = _fixture_pair()
    T, N = 4, 5
    inputs = torch.from_numpy(np.random.RandomState(13).randn(1, T, N).astype(np.float32))
    prepared = crit.prepare([[0, 1, 0]])
    base = torch.zeros(crit.num_transition_arcs, requires_grad=True)
    (analytic,) = torch.autograd.grad(crit.loss({"transitions": base}, inputs, prepared),
                                      base)
    eps = 1e-3
    numeric = np.zeros(crit.num_transition_arcs)
    for i in range(crit.num_transition_arcs):
        probe = torch.zeros(crit.num_transition_arcs)
        probe[i] = eps
        up = float(crit.loss({"transitions": probe}, inputs, prepared))
        down = float(crit.loss({"transitions": -probe}, inputs, prepared))
        numeric[i] = (up - down) / (2 * eps)
    np.testing.assert_allclose(analytic.numpy(), numeric, rtol=1e-2, atol=1e-3)
    assert np.abs(numeric).max() > 1e-2


@pytest.mark.parametrize("name", ["fixture", "trigram"])
def test_backoff_decode_matches_jax(name):
    crit, jcrit = CASES[name]()
    rng = np.random.RandomState(7)
    w = (rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32)
    tmpl = wcompile.build_decode_template(crit.transitions)
    jtmpl = jax_wcompile.build_decode_template(jcrit.transitions)
    for f in tmpl._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tmpl, f)),
                                      np.asarray(getattr(jtmpl, f)), err_msg=f)
    B, T = 5, 12
    x = rng.randn(B, T, crit.num_channels).astype(np.float32)
    lens = np.asarray([T, T - 1, T - 5, 2, 1], np.int32)
    preds = crit.viterbi(torch.from_numpy(x), {"transitions": torch.from_numpy(w)},
                         torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(x), {"transitions": jnp.asarray(w)},
                            jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [np.asarray(p).tolist() for p in j_preds]
    assert any(len(p) for p in preds)


def test_4gram_decode_takes_the_step_path_and_matches_jax(tmp_path):
    """The unpruned grapheme 4-gram over the long-line texts: its decode
    table (S=1,058, A=35,455) is refused by both packages' bucket plan and
    not destination-factorable, so the port decodes it through the
    per-step seg_max route and JAX (on the CPU) through its per-step
    oracle; random N(0, 1) logits have no near ties."""
    pre, texts = _texts(long=True)
    path = tmp_path / "4gram.bin"
    wgraph.save(path, bt.grapheme_lm(texts, pre.tokens, (0, 0, 0, 0)))
    kw = dict(blank="optional", allow_repeats=False, reduction="mean")
    crit = td.Transducer(pre.tokens, pre.graphemes_to_index, transitions=wgraph.load(path),
                         **kw)
    jcrit = jax_td.Transducer(pre.tokens, pre.graphemes_to_index,
                              transitions=jax_wfst.load(path), **kw)
    assert crit._factored_backoff_dst == jcrit._factored_backoff_dst is False
    rng = np.random.RandomState(4)
    w = (rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32)
    table = crit._decode_table({"transitions": torch.from_numpy(w)})
    jtable = jax_wcompile.apply_decode_weights(
        jax_wcompile.build_decode_template(jcrit.transitions), w)
    assert tuple(table.src.shape) == (35455,) and tuple(table.start.shape) == (1058,)
    assert vsp.build_plan(table) is None and jax_vsp.build_plan(jtable) is None
    B, T = 4, 12
    x = rng.randn(B, T, crit.num_channels).astype(np.float32)
    lens = np.asarray([T, T - 3, 5, T], np.int32)
    preds = crit.viterbi(torch.from_numpy(x), {"transitions": torch.from_numpy(w)},
                         torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(x), {"transitions": jnp.asarray(w)},
                            jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [np.asarray(p).tolist() for p in j_preds]
    assert all(len(p) for p in preds)


@pytest.mark.parametrize("ngram", [0, 2])
def test_forced_blank_decode_matches_jax(ngram):
    """``blank="forced"``: the alignment (argmax, or the bigram's Viterbi
    path) transduces to tokens only if it starts and ends in blank runs
    with one between every two token runs; else to nothing."""
    n, T = 3, 10
    args = ([(i,) for i in range(n)], {i: i for i in range(n)})
    kw = dict(ngram=ngram, blank="forced")
    crit, jcrit = td.Transducer(*args, **kw), jax_td.Transducer(*args, **kw)
    rng = np.random.RandomState(6)
    x = rng.randn(6, T, n + 1).astype(np.float32)
    x[0, np.arange(T), [3, 3, 0, 0, 3, 1, 3, 3, 2, 3]] += 20.0  # a feasible path
    lens = np.asarray([T, T, T - 2, 7, T, 4], np.int32)
    params = {"transitions": rng.randn(crit.num_transition_arcs).astype(np.float32) * 0.3}
    preds = crit.viterbi(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [np.asarray(p).tolist() for p in j_preds]
    assert preds[0].tolist() == [0, 1, 2] and any(len(p) == 0 for p in preds)


def test_huge_lm_decode_matches_jax(tmp_path):
    """A destination-factorable graph with S_c * N > 2^15 (a 200-token
    bigram, S_c = 204): both packages decode it through the
    destination-factored scan, with the same labels and outputs; the
    learned weights' update reaches the port's cached matrices."""
    ntok = 200
    rng = np.random.RandomState(3)
    lines = [[str(i) for i in rng.randint(0, ntok, 12)] for _ in range(400)]
    path = tmp_path / "lm.bin"
    wgraph.save(path, bt.build_from_lines(lines, [str(i) for i in range(ntok)], [0, 0],
                                          "optional", self_loops=True))
    args = ([(i,) for i in range(ntok)], {i: i for i in range(ntok)})
    kw = dict(blank="optional", reduction="mean")
    crit = td.Transducer(*args, transitions=wgraph.load(path), **kw)
    jcrit = jax_td.Transducer(*args, transitions=jax_wfst.load(path), **kw)
    assert crit._factored_backoff_dst and jcrit._factored_backoff_dst
    assert crit._norm_table.start.shape[0] * crit.num_channels > td._DECODE_FACTORED_MIN_ARCS
    B, T = 4, 12
    x = (rng.randn(B, T, ntok + 1) * 3).astype(np.float32)
    lens = np.asarray([T, T - 3, 5, 1], np.int32)
    w = torch.from_numpy((rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32))
    for _ in range(2):
        params = {"transitions": w}
        labels, _ = crit.viterbi_dispatch(torch.from_numpy(x), params, torch.from_numpy(lens))
        jlabels, _ = jcrit.viterbi_dispatch(jnp.asarray(x),
                                            {"transitions": jnp.asarray(w.numpy())},
                                            jnp.asarray(lens))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        preds = crit.viterbi(torch.from_numpy(x), params, torch.from_numpy(lens))
        assert [p.tolist() for p in preds] == [np.asarray(p).tolist() for p in jcrit.viterbi(
            jnp.asarray(x), {"transitions": jnp.asarray(w.numpy())}, jnp.asarray(lens))]
        assert all(len(p) for p in preds)
        with torch.no_grad():
            w.mul_(-1.0)  # an in-place update, as an optimizer makes


def test_train_step_matches_jax(tmp_path):
    """One SGD step of a narrow TDS2d with pruned_ngram_ctc.json's
    criterion (the grapheme trigram loaded from a file; random transitions
    with their own learning rate) against JAX."""
    _train_step_matches_jax(tmp_path)


def test_factored_train_step_matches_jax(tmp_path, monkeypatch):
    """The same step through the dense backoff factoring
    (``GTN_TRANSDUCER_FACTORED=on`` on both sides)."""
    monkeypatch.setattr(td, "_FACTORED_IMPL", "on")
    monkeypatch.setattr(jax_td, "_FACTORED_IMPL", "on")
    _train_step_matches_jax(tmp_path, factored=True)


def _train_step_matches_jax(tmp_path, factored=False):
    pre, texts = _texts()
    path = tmp_path / "trigram.bin"
    wgraph.save(path, bt.grapheme_lm(texts, pre.tokens))
    with open("configs/iamdb/pruned_ngram_ctc.json") as fid:
        crit_cfg = dict(json.load(fid)["criterion"], transitions=str(path))
    ds = synthetic.Dataset(None, pre, split="train")
    inputs, _, targets = utils.padding_collate([ds[i] for i in range(8)])
    crit, n_out = utils.load_criterion("transducer", pre, crit_cfg)
    jcrit = jax_td.Transducer(pre.tokens, pre.graphemes_to_index,
                              transitions=jax_wfst.load(path), blank="optional",
                              allow_repeats=False, reduction="mean")
    trans = (np.random.RandomState(0).randn(crit.num_transition_arcs) * 0.1).astype(
        np.float32)
    crit.params = criterion_params_from_jax({"transitions": trans})
    lr, crit_lr, max_grad_norm = 0.05, 0.1, 100.0

    flax_model = FlaxTDS2d(input_size=16, output_size=n_out, **MODEL)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    model = TDS2d(input_size=16, output_size=n_out, **MODEL)
    tds2d_from_flax(jax.tree_util.tree_map(np.asarray, variables), model)
    params = list(model.parameters()) + list(crit.params.values())
    old = [p.detach().double().clone() for p in params]

    jstep = jax_train.make_train_step(flax_model, jcrit, lr, crit_lr, max_grad_norm)
    jprep, prep = jcrit.prepare(targets), crit.prepare(targets)
    assert ("factored" in prep) == ("factored" in jprep) == factored
    jparams, jloss, _ = jstep(
        {"model": variables, "criterion": {"transitions": jnp.asarray(trans)}},
        jnp.asarray(inputs), jprep, jax.random.PRNGKey(1), jnp.float32(1.0),
    )
    step = train_mod.make_train_step(model, crit, lr, crit_lr, max_grad_norm)
    loss, _ = step(torch.from_numpy(inputs), prep, torch.Generator(), 1.0)
    assert abs(float(loss) - float(jloss)) < 1e-4

    ref = tds2d_from_flax(jax.tree_util.tree_map(np.asarray, jparams["model"]),
                          TDS2d(input_size=16, output_size=n_out, **MODEL))
    ref_params = list(ref.parameters()) + list(criterion_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams["criterion"])).values())
    names = [n for n, _ in model.named_parameters()] + list(crit.params)
    total = _updates_match(old, [p.detach().double() for p in params],
                           [q.detach().double() for q in ref_params], names)
    assert total > 0.05
    assert float((params[-1].detach().double() - old[-1]).norm()) > 1e-3


def test_synthetic_long_matches_jax():
    pre = synthetic_long.Preprocessor(None, num_features=16)
    jpre = jax_long.Preprocessor(None, num_features=16)
    ds = synthetic_long.Dataset(None, pre, split="validation")
    jds = jax_long.Dataset(None, jpre, split="validation")
    assert ds.texts == jds.texts and pre.tokens == jpre.tokens
    for i in (0, 7):
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
        np.testing.assert_array_equal(ds[i][1], jds[i][1])
    widths = [w for (w, _), _ in ds.sample_sizes()]
    assert min(widths) >= 4096 and max(widths) <= 9728
    dataset, *_ = train_mod.load_experiment({
        "data": {"dataset": "synthetic_long", "num_features": 16},
        "model_type": "tds2d", "model": MODEL, "criterion_type": "ctc"})
    assert dataset is synthetic_long


def test_profile_step_builds_the_trigram_for_a_missing_graph():
    with open("configs/iamdb/pruned_ngram_ctc.json") as fid:
        config = json.load(fid)
    data, crit_cfg = profile_step._data_and_criterion(config)
    assert data is synthetic_long
    pre, texts = _texts(long=True)
    _same_graph(wgraph.load(crit_cfg["transitions"]), bt.grapheme_lm(texts, pre.tokens))
    with open("configs/iamdb/ngram_ctc.json") as fid:
        assert profile_step._data_and_criterion(json.load(fid))[0] is synthetic


def test_normaliser_epsilon_index_is_built_once(monkeypatch):
    """On the kernel route (forced on CPU tensors, the kernels' plain
    versions standing in) the criterion builds its normaliser's epsilon
    ``arc_index`` at the first loss and hands the same index to every
    closure round of the second; the composed table's is built per loss."""
    from gtn_applications_tpu_torch.ops import _build
    from gtn_applications_tpu_torch.ops import seglse_pallas as slp
    from gtn_applications_tpu_torch.ops import sparse_scan_pallas as ssp

    crit, _ = _fixture_pair()
    rng = np.random.RandomState(3)
    targets, T = _targets("fixture", rng)
    x = torch.from_numpy(rng.randn(len(targets), T, crit.num_channels).astype(np.float32))
    params = {"transitions": torch.zeros(crit.num_transition_arcs)}
    prepared = crit.prepare(targets)
    built, used = [], []
    arc_index = slp.arc_index

    def build(*args):
        built.append(args[2])
        return arc_index(*args)

    def step(alpha, src, dst, w, em=None, idx=None):
        used.append(idx)
        return slp.seg_lse_fwd_plain(alpha, src, dst, w, 0.0 if em is None else em)

    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(slp, "arc_index", build)
    monkeypatch.setattr(slp, "seg_lse", step)
    monkeypatch.setattr(ssp, "sparse_scan_fwd_cuda", ssp.sparse_scan_fwd_plain)
    losses = []
    for _ in range(2):
        losses.append(float(crit.loss(params, x, prepared)))
        if len(losses) == 1:
            n_built, n_used = len(built), len(used)
    (norm_idx,) = crit._norm_indexes.values()
    assert n_built == 2 and len(built) == 3  # score and normaliser, then the score's
    assert len(used) == 2 * n_used
    rounds = sum(i is norm_idx for i in used[:n_used])
    assert rounds > 0 and sum(i is norm_idx for i in used[n_used:]) == rounds
    assert losses[0] == losses[1]
