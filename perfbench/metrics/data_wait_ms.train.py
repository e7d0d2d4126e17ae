"""Host ms a train step waits on the loader, prepare left out."""

from perfbench.metrics._common import span_seconds


def read(rec):
    if rec.mode != "train" or not rec.steps or not rec.window_spans:
        return None
    wait = span_seconds(rec, "fetch") - span_seconds(rec, "prepare")
    return 1e3 * wait / rec.steps
