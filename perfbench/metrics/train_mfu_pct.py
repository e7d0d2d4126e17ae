"""TDS2d's and its head's FLOPs at the lines' real widths, 3x the
forward, over the window's seconds, over float32's peak (%)."""

from perfbench.metrics._common import mfu_pct


def read(rec):
    return mfu_pct(rec) if rec.mode == "train" else None
