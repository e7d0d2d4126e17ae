"""A traffic generator: a corpus of text lines rendered as
handwriting-shaped images, from a traffic file's parameters and a seed,
and the port's dataset over it.

A traffic file that names ``"generator": "iam_lines"`` gives:

- ``mode``: ``train`` (the epoch loop's SGD steps) or ``eval`` (the
  evaluation pass);
- ``lines``: the corpus size;
- ``text``: ``inventory`` (a TSV of pieces and their log-probabilities),
  ``length_mean``, ``length_sd``, ``length_min``, ``length_max`` of a
  line in characters;
- ``render``: ``height`` and ``char_px`` of a glyph, ``hand_min`` and
  ``hand_max`` of the per-line hand size that scales its width;
- ``shape_seed``: the seed of the lines' sizes and texts.

The lines' sizes and texts are drawn from ``shape_seed`` alone, so that
every run seed measures the same work: the word decompositions' lattices
grow with the text.  The run seed draws the glyphs' pixels (and, in the
harness, the weights, the dropout masks and the batches' order).  Text is
drawn from the inventory's unigram model: pieces by exp(score), the first
a word-initial one, until the line holds its length, which then cuts it.
Each character renders as a per-character stripe pattern of the line's
glyph width, as uint8 pixels (white 255 is background), the way IAM's
PNGs decode.
"""

from pathlib import Path

import numpy as np

from perfbench.traffic import Corpus

WORDSEP = "▁"


def read_inventory(path):
    """(pieces, log-probabilities) of a TSV inventory."""
    pieces, scores = [], []
    with open(path, encoding="utf8") as fid:
        for line in fid:
            piece, score = line.rstrip("\n").split("\t")
            pieces.append(piece)
            scores.append(float(score))
    return pieces, np.asarray(scores)


def line_shapes(spec):
    """[(length, glyph_px)] of the corpus, from ``shape_seed`` only."""
    text, render = spec["text"], spec["render"]
    rng = np.random.default_rng(spec["shape_seed"])
    n = spec["lines"]
    lengths = np.clip(np.rint(rng.normal(text["length_mean"], text["length_sd"], n)),
                      text["length_min"], text["length_max"]).astype(int)
    hands = rng.uniform(render["hand_min"], render["hand_max"], n)
    glyph = np.maximum(np.rint(render["char_px"] * hands), 1).astype(int)
    return list(zip(lengths.tolist(), glyph.tolist()))


def _glyph_bank(chars, height, width, rng):
    """uint8 [len(chars), height, width]: a stripe pattern per character
    (a blank column band for the word separator), with mild noise."""
    n = len(chars)
    idx = np.arange(n)[:, None, None]
    ys = np.arange(height)[None, :, None] / height
    xs = np.arange(width)[None, None, :] / width
    phase = (idx + 1) / (n + 2)
    pattern = 0.5 + 0.5 * np.sin(2 * np.pi * ((idx % 7 + 2) * xs + phase + ys * (idx % 3)))
    ink = np.clip(pattern + rng.normal(0.0, 0.05, pattern.shape), 0.0, 1.0)
    ink[[i for i, c in enumerate(chars) if c == WORDSEP]] = 0.0
    return np.rint(255.0 * (1.0 - ink)).astype(np.uint8)


def make_corpus(spec, seed, root):
    """The corpus of ``spec`` for run seed ``seed``."""
    pieces, scores = read_inventory(Path(root) / spec["text"]["inventory"])
    chars = sorted(set("".join(pieces)))
    probs = np.exp(scores - scores.max())
    initial = np.asarray([p.startswith(WORDSEP) for p in pieces])
    p_all = probs / probs.sum()
    p_init = np.where(initial, probs, 0.0) / probs[initial].sum()
    rng = np.random.default_rng([spec["shape_seed"], 1])
    shapes = line_shapes(spec)
    height = spec["render"]["height"]
    banks = {w: _glyph_bank(chars, height, w, np.random.default_rng([seed, w]))
             for w in sorted({g for _, g in shapes})}
    index = {c: i for i, c in enumerate(chars)}
    texts, images = [], []
    for length, glyph in shapes:
        s = pieces[rng.choice(len(pieces), p=p_init)]
        while len(s) < length + 1:
            s += "".join(pieces[i] for i in rng.choice(len(pieces), 8, p=p_all))
        text = s[1:length + 1]
        ids = np.asarray([index[c] for c in text])
        img = banks[glyph][ids]                          # [L, H, g]
        images.append(np.ascontiguousarray(img.transpose(1, 0, 2).reshape(height, -1)))
        texts.append(text)
    return Corpus(texts, images, chars)


def make_dataset(corpus, preprocessor):
    """The corpus as the port's IAM dataset with ``fast_pipeline``: uint8
    lines, made float and normalised in the batch's collate, as
    ``utils.data_loader`` batches them."""
    from gtn_applications_tpu_torch.datasets import iamdb

    class Lines(iamdb.Dataset):
        def __init__(self, images, texts):
            self.fast_pipeline = True
            self.images, self.texts = images, texts

        def sample_sizes(self):
            return [((im.shape[1], im.shape[0]), len(t))
                    for im, t in zip(self.images, self.texts)]

        def __getitem__(self, index):
            return self.images[index], (1.0, 1.0), preprocessor.to_index(self.texts[index])

        def __len__(self):
            return len(self.images)

    return Lines(corpus.images, corpus.texts)
