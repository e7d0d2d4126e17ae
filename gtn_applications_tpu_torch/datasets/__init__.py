"""Datasets of the port: jax-free copies of the JAX package's text
preprocessing, the IAM handwriting dataset (``iamdb``; PIL on the host),
the synthetic glyph datasets (``synthetic`` and its long-line variant
``synthetic_long``), and the speech datasets: the mel features and
SpecAugment masks (``audio``), the JSONL-manifest audio dataset
(``audioset``) and its LibriSpeech and WSJ wrappers, their offline
manifest scripts (``preprocess_librispeech``, ``preprocess_wsj``) and
the synthetic tones (``synthetic_audio``)."""

from . import (
    audio, audioset, iamdb, librispeech, synthetic, synthetic_audio,
    synthetic_long, text, wsj,
)
from .text import TextPreprocessor, WORDSEP  # noqa: F401
