"""The port's Transducer criterion against the JAX package.

The graph builders and ``prepare``'s dense tables must equal JAX's exactly
(both compile through the same native library).  ``Transducer.loss`` and
its gradients to the logits and to the transitions are held to JAX's
default route (the analytic-VJP fold for the bigram scorer) within loss
rtol 1e-5 + atol 1e-5 and gradients rtol 2e-4 + atol 2e-5, the agreement
of JAX's own two routes (``tests/test_dense_scan.py``): ngram 1 and 2 at
the shapes of ``tests/test_dense_scan.py:118-146`` (ngram 2 with blank
none, optional without repeats, and forced, each of which ``prepare``
packs for the factored scan) and the
transitions-free word-decomposition case of :149-182.  The decode must
give JAX's tokens on random logits and random transitions (JAX's per-step
oracle, on data with no near ties) and must follow an in-place update of
the transitions.  One SGD step of a TDS2d with the ``ngram_ctc.json``
criterion matches JAX (loss 1e-4, each update within 1e-3 of its norm),
and ``train.py`` + ``test.py`` run that config end to end on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu import train as jax_train
from gtn_applications_tpu.criterions import transducer as jax_td
from gtn_applications_tpu.models import TDS2d as FlaxTDS2d
from gtn_applications_tpu.wfst import compile as jax_wcompile
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.criterions import transducer as td
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.models import TDS2d
from gtn_applications_tpu_torch.models.convert import (
    criterion_params_from_jax, tds2d_from_flax,
)
from gtn_applications_tpu_torch.wfst import compile as wcompile
from gtn_applications_tpu_torch.wfst import graph as wgraph

from tests.test_torch_train import MODEL, _updates_match

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
WORD_TOKENS = ["ab", "ba", "a", "b", "bb"]


def _same_graph(g, jg):
    assert g.start == jg.start
    assert g.finals == jg.finals
    for f in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
        assert getattr(g, f) == getattr(jg, f), f


@pytest.mark.parametrize("build", [
    lambda m: m.make_chain_graph([3, 1, 1, 4]),
    lambda m: m.make_transitions_graph(1, 5),
    lambda m: m.make_transitions_graph(2, 4),
    lambda m: m.make_lexicon_graph(WORD_TOKENS, {"a": 0, "b": 1}),
    lambda m: m.make_token_graph(list("abc"), "none", True),
    lambda m: m.make_token_graph(list("abc"), "optional", False),
    lambda m: m.make_token_graph(list("abc"), "forced", True),
], ids=["chain", "ngram1", "ngram2", "lexicon", "tokens_none",
        "tokens_optional_norep", "tokens_forced"])
def test_graph_builders_match_jax(build):
    _same_graph(build(td), build(jax_td))


def _numeric(Nt, **kw):
    args = ([(i,) for i in range(Nt)], {i: i for i in range(Nt)})
    return td.Transducer(*args, **kw), jax_td.Transducer(*args, **kw)


def _word_decomps():
    kw = dict(blank="optional", allow_repeats=False, reduction="mean")
    return (td.Transducer(WORD_TOKENS, {"a": 0, "b": 1}, **kw),
            jax_td.Transducer(WORD_TOKENS, {"a": 0, "b": 1}, **kw))


def _jax_prepare(jcrit, targets, monkeypatch):
    # JAX scores the transitions-free dense variant only on a TPU unless
    # told to; the port always does
    monkeypatch.setattr(jax_td, "_FACTORED_IMPL", "on")
    return jcrit.prepare(targets)


CASES = {
    "ngram1": lambda: _numeric(12, ngram=1, reduction="mean"),
    "ngram2": lambda: _numeric(12, ngram=2, reduction="mean"),
    "ngram2_optional_norep": lambda: _numeric(
        12, ngram=2, blank="optional", allow_repeats=False, reduction="mean"),
    "ngram2_forced": lambda: _numeric(12, ngram=2, blank="forced", reduction="mean"),
    "word_decomps": _word_decomps,
}


def _case(name, rng, B=4):
    crit, jcrit = CASES[name]()
    if name == "word_decomps":
        targets = [[0, 1, 0], [1, 1], [0, 0, 1, 1], [1]]
        T = 9
    else:
        targets = [rng.randint(0, 12, size=6).tolist() for _ in range(B)]
        T = 20
    return crit, jcrit, targets, T


@pytest.mark.parametrize("name", list(CASES))
def test_prepare_matches_jax(name, monkeypatch):
    rng = np.random.RandomState(3)
    crit, jcrit, targets, _ = _case(name, rng)
    prep = crit.prepare(targets)
    jprep = _jax_prepare(jcrit, targets, monkeypatch)
    assert "factored" in prep  # every case here scores through factored_scan
    for key in ("adj_exp", "lab_oh", "start", "accept"):
        np.testing.assert_array_equal(prep["factored"][key].numpy(),
                                      np.asarray(jprep["factored"][key]), err_msg=key)
    np.testing.assert_array_equal(prep["target_lengths"].numpy(),
                                  np.asarray(jprep["target_lengths"]))
    assert crit.num_transition_arcs == jcrit.num_transition_arcs


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(name, monkeypatch):
    rng = np.random.RandomState(5)
    crit, jcrit, targets, T = _case(name, rng)
    B, N = len(targets), crit.num_channels
    x = rng.randn(B, T, N).astype(np.float32)
    lens = rng.randint(T - 4, T + 1, size=B).astype(np.int32)
    trans = (rng.randn(crit.num_transition_arcs) * 0.3).astype(np.float32)
    params = {"transitions": trans} if crit.num_transition_arcs else {}

    jprep = _jax_prepare(jcrit, targets, monkeypatch)
    j_loss, (j_gp, j_gx) = jax.value_and_grad(
        lambda p, x: jcrit.loss(p, x, jprep, jnp.asarray(lens)), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    p_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss(p_t, x_t, crit.prepare(targets), torch.from_numpy(lens))
    grads = torch.autograd.grad(loss, [x_t] + list(p_t.values()))

    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_gx), err_msg="logits",
                               **GRAD_TOL)
    if params:
        np.testing.assert_allclose(grads[1].numpy(), np.asarray(j_gp["transitions"]),
                                   err_msg="transitions", **GRAD_TOL)


def test_bigram_loss_with_underflowing_sums_matches_jax(monkeypatch):
    """Logits x20 put most states' sums 88-104 nats below their shift by
    T=19: a float32 sum below the least normal number is dead in JAX (its
    devices and XLA's CPU flush it to zero) and must be dead in the port's
    factored scan too.  Kept alive, the 1e-37 floor of the log lifted such
    a state to e^-85 of its shift every frame: the loss ran 0.18 % low here
    (420.657 against JAX's 421.396), and 2430.67 against 2810.67 at logits
    x3, T=600.  Tolerances as test_loss_matches_jax."""
    rng = np.random.RandomState(0)
    crit, jcrit = _numeric(12, ngram=2, reduction="mean")
    B, T, N = 4, 19, crit.num_channels
    targets = [rng.randint(0, 12, size=6).tolist() for _ in range(B)]
    x = (rng.randn(B, T, N) * 20.0).astype(np.float32)
    lens = np.full(B, T, np.int32)
    trans = (rng.randn(crit.num_transition_arcs) * 0.3).astype(np.float32)

    jprep = _jax_prepare(jcrit, targets, monkeypatch)
    j_loss, (j_gt, j_gx) = jax.value_and_grad(
        lambda w, x: jcrit.loss({"transitions": w}, x, jprep, jnp.asarray(lens)),
        argnums=(0, 1))(jnp.asarray(trans), jnp.asarray(x))

    t_t = torch.from_numpy(trans).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss({"transitions": t_t}, x_t, crit.prepare(targets), torch.from_numpy(lens))
    g_x, g_t = torch.autograd.grad(loss, (x_t, t_t))

    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(j_gx), err_msg="logits", **GRAD_TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(j_gt), err_msg="transitions",
                               **GRAD_TOL)


@pytest.mark.parametrize("name", ["ngram1", "ngram2_optional_norep", "word_decomps"])
def test_viterbi_matches_jax(name):
    rng = np.random.RandomState(7)
    crit, jcrit, _, T = _case(name, rng)
    B, N = 5, crit.num_channels
    x = rng.randn(B, T, N).astype(np.float32)
    lens = np.asarray([T, T - 1, T - 5, 2, 1], np.int32)
    trans = (rng.randn(crit.num_transition_arcs) * 0.5).astype(np.float32)
    params = {"transitions": trans} if crit.num_transition_arcs else {}
    preds = crit.viterbi(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [np.asarray(p).tolist() for p in j_preds]
    assert any(len(p) for p in preds)


def _word_decomps_1k(B=2, pieces=15, seed=0):
    """Both packages' transitions-free Transducers over the 1k-wordpiece
    inventory (``benchmarks/word_pieces_scores_1000.tsv``), as bench.py's
    word-decomposition protocol builds them (blank optional, no repeats),
    and B targets of ``pieces`` random pieces spelled in graphemes."""
    import random

    with open("benchmarks/word_pieces_scores_1000.tsv") as fid:
        tokens = sorted(line.rstrip("\n").split("\t")[0] for line in fid)
    g2i = {c: i for i, c in enumerate(sorted({c for tok in tokens for c in tok}))}
    pick = random.Random(seed)
    targets = [[g2i[c] for _ in range(pieces) for c in pick.choice(tokens)] for _ in range(B)]
    kw = dict(blank="optional", allow_repeats=False, reduction="mean")
    return td.Transducer(tokens, g2i, **kw), jax_td.Transducer(tokens, g2i, **kw), targets


def test_word_decomps_1k_inventory_matches_jax(monkeypatch):
    """Word decomposition at vocabulary scale (B=2, T=30, 15 pieces over
    the 1,001 channels): the loss and the logit gradient against JAX's
    dense transitions-free route (``_FACTORED_IMPL`` on), loss rtol 1e-5 +
    atol 1e-5 and gradients GRAD_TOL, and the decode's tokens exactly."""
    crit, jcrit, targets = _word_decomps_1k()
    B, T, N = len(targets), 30, crit.num_channels
    rng = np.random.RandomState(9)
    x = rng.randn(B, T, N).astype(np.float32)
    lens = np.asarray([T, T - 3], np.int32)

    jprep = _jax_prepare(jcrit, targets, monkeypatch)
    j_loss, j_gx = jax.value_and_grad(
        lambda x: jcrit.loss({}, x, jprep, jnp.asarray(lens)))(jnp.asarray(x))
    prep = crit.prepare(targets)
    assert "factored" in prep
    assert prep["factored"]["adj_exp"].shape[1] > 200  # hundreds of states a sample
    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = crit.loss({}, x_t, prep, torch.from_numpy(lens))
    (gx,) = torch.autograd.grad(loss, x_t)

    assert float(loss.detach()) < 1e20  # every target fits in its frames
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), err_msg="logits", **GRAD_TOL)
    preds = crit.viterbi(torch.from_numpy(x), {}, torch.from_numpy(lens))
    j_preds = jcrit.viterbi(jnp.asarray(x), {}, jnp.asarray(lens))
    assert [p.tolist() for p in preds] == [np.asarray(p).tolist() for p in j_preds]


def test_decode_follows_in_place_update():
    """The decode table is cached per parameter tensor; an optimizer's
    in-place update must invalidate it."""
    crit, _ = _numeric(4, ngram=2)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 8, 4).astype(np.float32) * 0.1)
    p = torch.zeros(crit.num_transition_arcs, requires_grad=True)
    before = crit.viterbi(x, {"transitions": p})
    # make label 2 after label 2, and starting with 2, overwhelmingly likely
    N = 4
    with torch.no_grad():
        p[2] += 50.0
        p[N + 2 * N + 2] += 50.0
    after = crit.viterbi(x, {"transitions": p})
    assert [a.tolist() for a in after] == [[2], [2]]
    assert [b.tolist() for b in before] != [a.tolist() for a in after]
    fresh, _ = _numeric(4, ngram=2)
    assert [f.tolist() for f in fresh.viterbi(x, {"transitions": p})] == [[2], [2]]


def test_decode_template_matches_jax():
    rng = np.random.RandomState(2)
    g = td.make_transitions_graph(2, 5)
    jg = jax_td.make_transitions_graph(2, 5)
    w = (rng.randn(g.num_arcs()) * 0.5).astype(np.float32)
    table = wcompile.apply_decode_weights(wcompile.build_decode_template(g), w)
    jtable = jax_wcompile.apply_decode_weights(jax_wcompile.build_decode_template(jg), w)
    for f in ("src", "dst", "label", "weight", "start", "accept", "eps_src",
              "eps_dst", "eps_weight"):
        np.testing.assert_array_equal(getattr(table, f).numpy(),
                                      np.asarray(getattr(jtable, f)), err_msg=f)
    assert table.eps_depth == jtable.eps_depth == 0


def test_what_is_not_ported_raises(monkeypatch, tmp_path):
    """What raised before now runs: blank="forced" decodes (through the
    native ``forced_collapse``; a feasible alignment to its tokens, an
    infeasible one to nothing), and the composed path takes a loaded
    transitions graph (also from a file), ngram 3, and a batch the dense
    packing refuses."""
    tokens, g2i = [(0,), (1,)], {0: 0, 1: 1}
    forced = td.Transducer(tokens, g2i, blank="forced")
    x = torch.full((2, 4, 3), -5.0)
    for b, path in enumerate([(2, 0, 0, 2), (2, 0, 1, 2)]):  # blank is channel 2
        x[b, torch.arange(4), torch.tensor(path)] = 5.0
    assert [p.tolist() for p in forced.viterbi(x)] == [[0], []]
    loaded = td.Transducer(tokens, g2i, transitions=td.make_transitions_graph(2, 2))
    assert "table" in loaded.prepare([[0, 1]])
    assert "table" in td.Transducer(tokens, g2i, ngram=3).prepare([[0, 1]])
    monkeypatch.setattr(td, "_DENSE_MAX_WORKSET", 0)
    assert "table" in td.Transducer(tokens, g2i).prepare([[0, 1]])
    pre = synthetic.Preprocessor(None, num_features=16)
    path = tmp_path / "lm.bin"
    wgraph.save(path, td.make_transitions_graph(2, pre.num_tokens))
    crit, _ = utils.load_criterion("transducer", pre, {"transitions": str(path)})
    assert crit.num_transition_arcs == td.make_transitions_graph(2, pre.num_tokens).num_arcs()


NGRAM_CTC = {"allow_repeats": False, "blank": "optional", "ngram": 2}


def test_train_step_matches_jax():
    """One SGD step of a small TDS2d with the ngram_ctc.json criterion
    (random transitions, their own learning rate) against JAX."""
    pre = synthetic.Preprocessor(None, num_features=16)
    ds = synthetic.Dataset(None, pre, split="train")
    inputs, _, targets = utils.padding_collate([ds[i] for i in range(8)])
    crit, n_out = utils.load_criterion("transducer", pre, NGRAM_CTC)
    jcrit = jax_td.Transducer(pre.tokens, pre.graphemes_to_index, ngram=2,
                              blank="optional", allow_repeats=False, reduction="mean")
    trans = (np.random.RandomState(0).randn(crit.num_transition_arcs) * 0.1).astype(
        np.float32)
    jcrit_params = {"transitions": jnp.asarray(trans)}
    crit.params = criterion_params_from_jax({"transitions": trans})
    lr, crit_lr, max_grad_norm = 0.05, 0.1, 100.0

    flax_model = FlaxTDS2d(input_size=16, output_size=n_out, **MODEL)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    model = TDS2d(input_size=16, output_size=n_out, **MODEL)
    tds2d_from_flax(jax.tree_util.tree_map(np.asarray, variables), model)
    params = list(model.parameters()) + list(crit.params.values())
    old = [p.detach().double().clone() for p in params]

    jstep = jax_train.make_train_step(flax_model, jcrit, lr, crit_lr, max_grad_norm)
    jparams, jloss, _ = jstep(
        {"model": variables, "criterion": jcrit_params}, jnp.asarray(inputs),
        jcrit.prepare(targets), jax.random.PRNGKey(1), jnp.float32(1.0),
    )
    step = train_mod.make_train_step(model, crit, lr, crit_lr, max_grad_norm)
    loss, _ = step(torch.from_numpy(inputs), crit.prepare(targets),
                   torch.Generator(), 1.0)
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


def test_ngram_ctc_train_then_test_cpu(tmp_path):
    """configs/iamdb/ngram_ctc.json's criterion and optimiser sections on a
    small TDS2d, synthetic data: train.py then test.py with --disable_cuda;
    the trained transitions are saved and restored."""
    with open("configs/iamdb/ngram_ctc.json") as fid:
        base = json.load(fid)
    config = {
        "seed": 0, "data": {"dataset": "synthetic", "num_features": 16},
        "model_type": "tds2d", "model": MODEL,
        "criterion_type": base["criterion_type"], "criterion": base["criterion"],
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
