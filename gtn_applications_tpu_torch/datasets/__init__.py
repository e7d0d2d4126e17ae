"""Datasets of the port: jax-free copies of the JAX package's text
preprocessing and synthetic glyph datasets (``synthetic`` and its
long-line variant ``synthetic_long``).  ``iamdb`` waits for the data to be
in the repository."""

from . import synthetic, synthetic_long, text
