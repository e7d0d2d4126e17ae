"""Datasets of the port: jax-free copies of the JAX package's text
preprocessing, the IAM handwriting dataset (``iamdb``; PIL on the host)
and the synthetic glyph datasets (``synthetic`` and its long-line variant
``synthetic_long``).  The speech datasets are not ported yet (ROADMAP
queue A item 16)."""

from . import iamdb, synthetic, synthetic_long, text
