"""The port's wordpiece and LM scripts (``scripts/wordpiece.py``,
``make_wordpieces.py``, ``fit_piece_scores.py``, ``load_arpa.py``) against
the JAX package's.

Corpora are made with numpy from a seed (the synthetic glyph corpus).  The
trainers run the same code in one process, so the models are compared
exactly, dict order included, by the native route and the Python one
(``TW_NATIVE=0``); the token and lexicon files byte for byte.  The native
E-step is held against the Python one within 1e-6 relative (the native
model holds its log-probabilities in float32).  The ARPA
loader is held against JAX's and against golden scores computed by hand.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gtn_applications_tpu import wfst as jwfst
from gtn_applications_tpu.scripts import fit_piece_scores as jfit
from gtn_applications_tpu.scripts import load_arpa as jarpa
from gtn_applications_tpu.scripts import make_wordpieces as jmake
from gtn_applications_tpu.scripts import wordpiece as jwp
from gtn_applications_tpu.wfst import native as jnative
from gtn_applications_tpu_torch import wfst
from gtn_applications_tpu_torch.datasets import synthetic
from gtn_applications_tpu_torch.scripts import fit_piece_scores, load_arpa
from gtn_applications_tpu_torch.scripts import make_wordpieces, wordpiece
from gtn_applications_tpu_torch.wfst import native

from tests.test_datasets import _make_iam_fixture
from tests.test_scripts import ARPA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = os.path.join(ROOT, "benchmarks", "word_pieces_scores_1000.tsv")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "wordpiece_segmentations_1000.json")


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """Both packages on the native segmenter, or both on the Python DP
    (JAX reads ``TW_NATIVE`` when it loads its library)."""
    if request.param == "python":
        monkeypatch.setenv("TW_NATIVE", "0")
        monkeypatch.setattr(jnative, "_LIB", None)
        assert not native.enabled() and not jnative.available()
    else:
        assert native.enabled() and jnative.available()
    return request.param


def _corpus(n, seed=5):
    return synthetic._make_corpus(n, seed, 1, 4)


@pytest.mark.parametrize("vocab_size", [40, 120])
def test_train_unigram_and_encode_match_jax(route, vocab_size):
    corpus = _corpus(80 if route == "python" else 300)
    model = wordpiece.train_unigram(corpus, vocab_size, em_iters=2)
    ref = jwp.train_unigram(corpus, vocab_size, em_iters=2)
    assert list(model.log_probs.items()) == list(ref.log_probs.items())
    assert len(model.log_probs) == vocab_size
    words = sorted({w for t in corpus for w in t.split("▁")}) + ["jihgfedcba", "xyz"]
    piece_to_id = {p: i + 1 for i, p in enumerate(model.log_probs)}
    for w in words:
        assert model.encode(w) == ref.encode(w)
        assert "".join(model.encode(w)) == "▁" + w
        assert model.encode_ids(w, piece_to_id) == ref.encode_ids(w, piece_to_id)
    # user symbols are kept, whatever their count
    sym = wordpiece.train_unigram(corpus[:40], 30, user_symbols=["/"])
    assert "/" in sym.log_probs
    assert list(sym.log_probs.items()) == list(
        jwp.train_unigram(corpus[:40], 30, user_symbols=["/"]).log_probs.items())


def test_native_estep_matches_python():
    sentences = ["▁" + s for s in _corpus(200, seed=9)] + ["▁xyz▁ab"]
    model = wordpiece.train_unigram(_corpus(200, seed=9), 60)
    native_counts, native_ll = wordpiece._e_step(sentences, model)
    python_model = wordpiece.UnigramModel(model.log_probs)
    python_model._native = False
    py_counts, py_ll = wordpiece._e_step(sentences, python_model)
    assert set(native_counts) <= set(py_counts)
    # a character no piece covers ("x", "y", "z") is counted by the Python
    # E-step only, in JAX's as in the port's
    assert set(py_counts) - set(model.log_probs) == set("xyz")
    for p in model.log_probs:
        # the Python side keeps posteriors above exp(-30), the native one all;
        # the native model holds its log-probabilities in float32
        c = py_counts.get(p, 0.0)
        assert abs(native_counts.get(p, 0.0) - c) <= 1e-6 * max(c, 1.0), p
    assert abs(native_ll - py_ll) <= 1e-6 * abs(py_ll)
    # and the encoder's batch call agrees with its one-text call
    enc = model._native_encoder()
    texts = ["▁" + s for s in sentences[:50]]
    assert enc.encode_batch(texts) == [enc.encode(t) for t in texts]


def test_fit_scores_and_load_scores_match_jax(route, tmp_path):
    pieces, log_probs = fit_piece_scores.load_scores(SCORES)
    assert (pieces, log_probs) == jfit.load_scores(SCORES)
    pieces = pieces[:150]
    corpus = fit_piece_scores.zipf_corpus(pieces, num_sentences=100, seed=3)
    assert corpus == jfit.zipf_corpus(pieces, num_sentences=100, seed=3)
    model = wordpiece.fit_scores(corpus, pieces, em_iters=2)
    ref = jwp.fit_scores(corpus, pieces, em_iters=2)
    assert list(model.log_probs.items()) == list(ref.log_probs.items())
    # the CLI writes the same TSV, which reads back as the model
    (tmp_path / "pieces.txt").write_text("\n".join(pieces) + "\n")
    (tmp_path / "corpus.txt").write_text(
        "\n".join(s.replace("▁", " ") for s in corpus[:60]) + "\n")
    for mod, out in ((fit_piece_scores, "port.tsv"), (jfit, "jax.tsv")):
        mod.main(["--pieces", str(tmp_path / "pieces.txt"), "--corpus",
                  str(tmp_path / "corpus.txt"), "--output", str(tmp_path / out),
                  "--em_iters", "2"])
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    got_pieces, got = fit_piece_scores.load_scores(tmp_path / "port.tsv")
    assert got_pieces == pieces and len(got) == len(pieces)


def test_reference_inventory_segmentations():
    """The 1,000-piece inventory with its fitted scores segments the
    checked-in golden words as JAX's does, by both routes."""
    pieces, lp = fit_piece_scores.load_scores(SCORES)
    piece_to_id = {p: i + 1 for i, p in enumerate(pieces)}
    with open(GOLDEN) as fid:
        golden = json.load(fid)
    model, ref = wordpiece.UnigramModel(lp), jwp.UnigramModel(lp)
    python_model = wordpiece.UnigramModel(lp)
    python_model._native = False
    for word, ids in golden.items():
        assert model.encode_ids(word, piece_to_id) == ids, word
        assert ref.encode_ids(word, piece_to_id) == ids, word
        assert python_model.encode_ids(word, piece_to_id) == ids, word


# lines in no split list: the corpus make_wordpieces trains IAM on.  Few
# characters: the trainer keeps every character, so an inventory smaller
# than the characters would never shrink to its size (in JAX's too)
EXTRA_LINES = [
    "a03-000-00 ok 150 20 300 500 1200 80 the|cat|ate|the|hat",
    "a03-000-01 ok 150 20 300 500 1200 80 a|cat|in|a|hat",
    "a03-000-02 ok 150 20 300 500 1200 80 the|hat|and|the|cat",
    "a03-001-00 ok 150 20 300 500 1200 80 eat|the|tea|then|the|hat",
]
IAM_WORDS = 10  # distinct words of EXTRA_LINES


@pytest.fixture
def iam_root(tmp_path):
    root = tmp_path / "iam"
    root.mkdir()
    _make_iam_fixture(str(root))  # the images are not read here
    with open(root / "lines.txt", "a") as fid:
        fid.write("\n".join(EXTRA_LINES) + "\n")
    return str(root)


def _files(prefix, n):
    return [open(f"{prefix}_{kind}_{n}.txt", "rb").read() for kind in ("tokens", "lex")]


def test_save_and_build_pieces_byte_equal_on_iam(route, iam_root, tmp_path):
    corpus = make_wordpieces._iam_corpus(iam_root)
    assert corpus == jmake._iam_corpus(iam_root)
    assert len(corpus[0]) == len(EXTRA_LINES) and corpus[2] == ["/"]
    text = tmp_path / "text.txt"
    text.write_text("\n".join(_corpus(120, seed=2)) + "\n")
    for n, text_file in ((20, None), (25, str(text))):
        make_wordpieces.build_pieces("iamdb", iam_root, n, str(tmp_path / "port"),
                                     text_file)
        jmake.build_pieces("iamdb", iam_root, n, str(tmp_path / "jax"), text_file)
        port, ref = _files(tmp_path / "port", n), _files(tmp_path / "jax", n)
        assert port == ref
        assert len(port[0].decode().split("\n")) == n
        assert len(port[1].decode().splitlines()) == IAM_WORDS
    # save_pieces on a model trained elsewhere, with a word no piece covers
    model = wordpiece.train_unigram(_corpus(100), 30)
    vocab = ["abc", "jij", "xyz", "a"]
    make_wordpieces.save_pieces(model, 30, str(tmp_path / "port_s"), vocab)
    jmake.save_pieces(jwp.train_unigram(_corpus(100), 30), 30,
                      str(tmp_path / "jax_s"), vocab)
    assert _files(tmp_path / "port_s", 30) == _files(tmp_path / "jax_s", 30)


def test_speech_corpus_builders_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    for name in ("train_si284", "train-clean-100"):
        with open(tmp_path / f"{name}.json", "w") as fid:
            for _ in range(6):
                text = " ".join(rng.choice(words, rng.randint(1, 5)))
                fid.write(json.dumps({"text": text, "duration": 1.0, "audio": "x"}) + "\n")
    (tmp_path / "vocab20ko.txt").write_text("# header\nALPHA\nBeta\nzeta\n")
    for name in ("wsj", "librispeech"):
        got = make_wordpieces.CORPUS_BUILDERS[name](str(tmp_path))
        assert got == jmake.CORPUS_BUILDERS[name](str(tmp_path))
        assert len(got[0]) == 6
    assert make_wordpieces._wsj_corpus(str(tmp_path))[1] == ["alpha", "beta", "zeta"]


def test_make_wordpieces_cli_runs_from_the_port(iam_root, tmp_path):
    """``python -m gtn_applications_tpu_torch.scripts.make_wordpieces``
    without JAX in the process writes the files JAX's CLI writes.  Pieces
    of equal log-probability keep the order of a set of strings, which
    follows the string hash: both processes take one PYTHONHASHSEED."""
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'gtn_applications_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import runpy\n"
            "runpy.run_module('gtn_applications_tpu_torch.scripts.make_wordpieces',"
            " run_name='__main__')\n")
    jax_code = ("from gtn_applications_tpu.scripts import make_wordpieces\n"
                "make_wordpieces.main()\n")
    argv = ["--dataset", "iamdb", "--data_dir", iam_root, "--num_pieces", "20"]
    env = dict(os.environ, PYTHONHASHSEED="7")
    for c, prefix in ((code, "port"), (jax_code, "jax")):
        out = subprocess.run(
            [sys.executable, "-c", c] + argv + ["--output_prefix", str(tmp_path / prefix)],
            cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        assert f"Encoding vocabulary of size {IAM_WORDS}." in out.stdout
    assert _files(tmp_path / "port", 20) == _files(tmp_path / "jax", 20)


# log10 Katz-backoff scores of ARPA (tests/test_scripts.py), BY HAND: each
# step is the listed bigram's log-prob, or bow(history) + the unigram's
#   "wood jean":      -0.3 -0.4 -0.5
#   "jean wood jean": (-0.4-0.8) -0.6 -0.4 -0.5
#   "wood wood jean": -0.3 (-0.25-0.7) -0.4 -0.5
#   "jean":           (-0.4-0.8) -0.5
#   "xyzzy wood" (<unk>): (-0.4-1.2) (-0.3-0.7) (-0.25-1.1)
HAND_GOLDENS = {
    "wood jean": -1.2,
    "jean wood jean": -2.7,
    "wood wood jean": -2.15,
    "jean": -1.7,
    "xyzzy wood": -3.95,
}


@pytest.fixture
def arpa_path(tmp_path):
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA)
    return str(path)


def test_load_arpa_matches_jax_and_hand_goldens(arpa_path):
    counts, vocab = load_arpa.read_counts_from_arpa(arpa_path)
    assert (counts, vocab) == jarpa.read_counts_from_arpa(arpa_path)
    assert vocab == {"<unk>": 0, "<s>": 1, "</s>": 2, "wood": 3, "jean": 4}
    assert counts[0][(3,)] == (-0.7, -0.25) and counts[1][(4, 2)] == (-0.5, None)
    g, jg = load_arpa.build_lm_graph(counts, vocab), jarpa.build_lm_graph(counts, vocab)
    assert (g.start, g.finals, list(g.arcs())) == (jg.start, jg.finals, list(jg.arcs()))
    for sent, golden in HAND_GOLDENS.items():
        gs = load_arpa.build_sentence_graph(sent, vocab)
        jgs = jarpa.build_setence_graph(sent, vocab)
        assert list(gs.arcs()) == list(jgs.arcs())
        oracle = load_arpa.score_sentence(counts, vocab, sent)
        assert oracle == jarpa.score_sentence(counts, vocab, sent)
        assert abs(oracle - golden) < 1e-9, sent
        inter = wfst.intersect(g, gs)
        score = wfst.viterbi_score(inter)
        assert score == jwfst.viterbi_score(jwfst.intersect(jg, jgs))
        assert abs(score - golden) < 1e-5, sent
        assert abs(wfst.ops.viterbi_score_py(wfst.ops.compose_py(g, gs)) - golden) < 1e-9
    assert load_arpa.score_sentence(counts, vocab, "wood", bos=False, eos=False) == -0.7
    with pytest.raises(ValueError, match="order >= 2"):
        load_arpa.build_lm_graph(counts[:1], vocab)


def test_load_arpa_refuses_malformed_headers(tmp_path):
    bad = tmp_path / "bad.arpa"
    bad.write_text(ARPA.replace("ngram 1=5", "ngram 1=6"))
    with pytest.raises(ValueError, match="header declared 6"):
        load_arpa.read_counts_from_arpa(str(bad))
    bad.write_text(ARPA.replace("ngram 2=4", "ngram 3=4"))
    with pytest.raises(ValueError, match="malformed ARPA header"):
        load_arpa.read_counts_from_arpa(str(bad))


def _bigram_arpa(path, words=1000, bigrams=3000, seed=0):
    """A bigram ARPA file over ``words`` words, numpy from a seed.  main's
    self-test draws its sentences from the whole vocabulary, <s> and </s>
    too, which no sentence can hold: a large vocabulary keeps them out of
    its first sentences."""
    rng = np.random.RandomState(seed)
    vocab = ["<unk>", "<s>", "</s>"] + [f"w{i}" for i in range(words)]
    pairs = {(int(a), int(b)) for a, b in rng.randint(1, len(vocab), (bigrams, 2))
             if a != 2 and b != 1}
    lines = ["\\data\\", f"ngram 1={len(vocab)}", f"ngram 2={len(pairs)}", "",
             "\\1-grams:"]
    for i, w in enumerate(vocab):
        bow = "" if w == "</s>" else f"\t{-rng.rand():.4f}"
        lines.append(f"{-1 - 3 * rng.rand():.4f}\t{w}{bow}")
    lines += ["", "\\2-grams:"]
    lines += [f"{-2 * rng.rand():.4f}\t{vocab[a]} {vocab[b]}" for a, b in sorted(pairs)]
    lines += ["", "\\end\\"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_load_arpa_main_matches_jax(tmp_path, capsys):
    """``main``'s self-test (the WFST against the backoff recursion on
    random sentences) prints what JAX's prints, and its Graphviz file is
    JAX's; ``python -m`` runs it from the port without JAX."""
    argv = ["--arpa", _bigram_arpa(tmp_path / "lm.arpa"), "--sentences", "8"]
    load_arpa.main(argv + ["--write_dot", str(tmp_path / "port.dot")])
    port = capsys.readouterr().out
    jarpa.main(argv + ["--write_dot", str(tmp_path / "jax.dot")])
    assert port == capsys.readouterr().out
    assert port.endswith("OK\n") and port.count("oracle:") == 8
    assert (tmp_path / "port.dot").read_bytes() == (tmp_path / "jax.dot").read_bytes()
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'gtn_applications_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import runpy\n"
            "runpy.run_module('gtn_applications_tpu_torch.scripts.load_arpa',"
            " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code] + argv, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == port
