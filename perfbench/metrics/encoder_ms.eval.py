"""CUDA-event ms of the encoder's forward, a batch, each batch of the
corpus timed alone after the window."""

from perfbench.metrics._common import mean


def read(rec):
    return mean(rec.encoder_ms) if rec.mode == "eval" else None
