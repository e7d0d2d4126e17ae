"""CUDA-event ms of the criterion's loss forward and backward on the
encoder's logits, a batch, each batch of the corpus timed alone."""

from perfbench.metrics._common import mean


def read(rec):
    return mean(rec.criterion_ms) if rec.mode == "train" else None
