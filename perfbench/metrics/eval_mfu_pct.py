"""TDS2d's and its head's forward FLOPs at the lines' real widths
over the window's seconds, over float32's peak (%)."""

from perfbench.metrics._common import mfu_pct


def read(rec):
    return mfu_pct(rec) if rec.mode == "eval" else None
