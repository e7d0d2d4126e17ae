"""Synthetic glyph dataset for smoke tests and benchmarks (no download).

A copy of ``gtn_applications_tpu/datasets/synthetic.py``, kept in the port
so that it imports nothing of the JAX package.

Generates deterministic "handwriting-like" images: each character of a
random text renders as a distinct vertical-stripe glyph pattern.  Mirrors
the iamdb Dataset/Preprocessor interface so the full train/test entry points run
end-to-end without the (license-gated) IAM data.
"""

import numpy as np

from .text import TextPreprocessor, WORDSEP

_ALPHABET = "abcdefghij"
_GLYPH_W = 12


def _glyph(char_idx, height, rng, width=_GLYPH_W):
    """A per-character deterministic pattern with mild noise."""
    phase = (char_idx + 1) / (len(_ALPHABET) + 2)
    ys = np.arange(height)[:, None] / height
    xs = np.arange(width)[None, :] / width
    pattern = 0.5 + 0.5 * np.sin(
        2 * np.pi * ((char_idx + 2) * xs + phase + ys * (char_idx % 3))
    )
    g = np.clip(pattern + rng.randn(height, width) * 0.05, 0, 1)
    return g.astype(np.float32)


def _make_corpus(num_samples, seed, min_words=1, max_words=3):
    rng = np.random.RandomState(seed)
    texts = []
    for _ in range(num_samples):
        words = []
        for _ in range(rng.randint(min_words, max_words + 1)):
            n = rng.randint(2, 5)
            words.append("".join(_ALPHABET[i] for i in rng.randint(0, len(_ALPHABET), n)))
        texts.append(WORDSEP.join(words))
    return texts


class Dataset:
    def __init__(self, data_path, preprocessor, split="train", augment=False,
                 glyph_w=_GLYPH_W, min_words=1, max_words=3):
        seeds = {"train": 1, "validation": 2, "test": 3}
        sizes = {"train": 64, "validation": 16, "test": 16}
        seed = seeds.get(split)
        if seed is None:
            raise ValueError(f"Invalid split {split}")
        self.preprocessor = preprocessor
        self.texts = _make_corpus(sizes[split], seed, min_words, max_words)
        self.height = preprocessor.num_features
        self.rng = np.random.RandomState(seed + 100)
        self.images = []
        for text in self.texts:
            chars = [c for c in text]
            img = np.concatenate(
                [
                    _glyph(
                        _ALPHABET.index(c) if c in _ALPHABET else len(_ALPHABET),
                        self.height,
                        self.rng,
                        glyph_w,
                    )
                    for c in chars
                ],
                axis=1,
            )
            self.images.append(img)

    def sample_sizes(self):
        return [
            ((img.shape[1], img.shape[0]), len(text))
            for img, text in zip(self.images, self.texts)
        ]

    def __getitem__(self, index):
        img = self.images[index]
        return img, self.preprocessor.to_index(self.texts[index])

    def __len__(self):
        return len(self.texts)


class Preprocessor(TextPreprocessor):
    def __init__(
        self,
        data_path,
        num_features,
        tokens_path=None,
        lexicon_path=None,
        use_words=False,
        prepend_wordsep=False,
    ):
        train_text = _make_corpus(64, 1)
        super().__init__(
            train_text,
            tokens_path=tokens_path,
            lexicon_path=lexicon_path,
            prepend_wordsep=prepend_wordsep,
        )
        self.num_features = num_features
        self._use_words = use_words

    @property
    def use_words(self):
        return self._use_words
