"""Share of the profiled eval pass's wall time with no device
operation running (%), from the union of their intervals."""

from perfbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec.mode == "eval" else None
