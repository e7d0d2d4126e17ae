"""Host ms of criterion.prepare a train step."""

from perfbench.metrics._common import span_seconds


def read(rec):
    if rec.mode != "train" or not rec.steps or not rec.window_spans:
        return None
    return 1e3 * span_seconds(rec, "prepare") / rec.steps
