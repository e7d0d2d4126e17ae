"""Shared reductions of the readers."""

from perfbench import yardstick


def kernels(rec):
    """Kernel launches (not copies or fills) in the profiled sub-window."""
    return sum(1 for name, _, _ in rec.events if not name.startswith(("Memcpy", "Memset")))


def span_seconds(rec, name):
    """Seconds of the window's host spans called ``name``."""
    return sum(e - s for n, s, e in rec.spans[:rec.window_spans] if n == name) / 1e9


def idle_pct(rec):
    if not rec.events or not rec.profile_window:
        return None
    start, end = rec.profile_window
    busy = yardstick.union_seconds([(s, e) for _, s, e in rec.events])
    return 100.0 * (1.0 - busy / ((end - start) / 1e9))


def mfu_pct(rec):
    if not rec.window_s or not rec.window_flops:
        return None
    return 100.0 * rec.window_flops / rec.window_s / yardstick.PEAKS["float32_flops"]


def mean(values):
    return sum(values) / len(values) if values else None

