"""Synthetic audio dataset: per-character tone sequences through the mel
spectrogram.

A copy of ``gtn_applications_tpu/datasets/synthetic_audio.py``: the glyph
corpus of ``datasets.synthetic``, each character a tone whose frequency
encodes it, then ``audio.MelSpectrogram`` and ``log_normalize`` (no
downloads; the speech path end to end, as ``synthetic`` is for images).
"""

import numpy as np

from .audio import MelSpectrogram, log_normalize
from .synthetic import _ALPHABET, _make_corpus
from .text import TextPreprocessor

SAMPLE_RATE = 16000
_CHAR_MS = 80


def _render(text, rng):
    """Each character becomes a tone whose frequency encodes its identity."""
    chunks = []
    n = SAMPLE_RATE * _CHAR_MS // 1000
    t = np.arange(n) / SAMPLE_RATE
    for c in text:
        idx = _ALPHABET.index(c) if c in _ALPHABET else len(_ALPHABET)
        freq = 300.0 * (1.25 ** idx)
        chunks.append(np.sin(2 * np.pi * freq * t))
    x = np.concatenate(chunks) if chunks else np.zeros(n)
    x = x + rng.randn(len(x)) * 0.05
    return x.astype(np.float32)


class Dataset:
    def __init__(self, data_path, preprocessor, split="train", augment=False):
        seeds = {"train": 11, "validation": 12, "test": 13}
        sizes = {"train": 48, "validation": 12, "test": 12}
        seed = seeds.get(split)
        if seed is None:
            raise ValueError(f"Invalid split {split}")
        self.preprocessor = preprocessor
        self.texts = _make_corpus(sizes[split], seed, min_words=1, max_words=2)
        rng = np.random.RandomState(seed + 100)
        self.mel = MelSpectrogram(
            sample_rate=SAMPLE_RATE,
            n_fft=SAMPLE_RATE * 25 // 1000,
            n_mels=preprocessor.num_features,
            hop_length=SAMPLE_RATE * 10 // 1000,
        )
        self.feats = [
            log_normalize(self.mel(_render(t, rng))) for t in self.texts
        ]

    def sample_sizes(self):
        return [
            ((f.shape[1], f.shape[0]), len(t))
            for f, t in zip(self.feats, self.texts)
        ]

    def __getitem__(self, index):
        return self.feats[index], self.preprocessor.to_index(self.texts[index])

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
        train_text = _make_corpus(48, 11, min_words=1, max_words=2)
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
