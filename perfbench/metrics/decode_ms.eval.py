"""Host ms of viterbi_dispatch and viterbi_finalize an evaluated batch."""

from perfbench.metrics._common import span_seconds


def read(rec):
    if rec.mode != "eval" or not rec.steps or not rec.window_spans:
        return None
    return 1e3 * span_seconds(rec, "decode") / rec.steps
