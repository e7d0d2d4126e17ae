"""Datasets of the port: jax-free copies of the JAX package's text
preprocessing and synthetic glyph dataset.  ``iamdb`` waits for the data
to be in the repository."""

from . import synthetic, text
