"""The benchmark's yardstick: the chip's peaks, a criterion's least time
from its shapes, and the reduction of device intervals to busy time.
These count the work whatever implements it; a model's FLOPs are counted
beside its plain reference (``reference/<name>.py``, ``forward_flops``).
"""

# NVIDIA H100 SXM, dense rates, at its 700 W limit (NVIDIA's data sheet)
PEAKS = {
    "float32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def criterion_least_seconds(batch, frames, channels, states, arcs):
    """The least time of a loss's forward and backward over logits
    [batch, frames, channels] and lattices of ``states`` and ``arcs``
    (totals over the batch): the logits read once and their gradient
    written once, against 3 operations an arc and 2 a state a frame, each
    pass (forward, backward's two).  Returns (seconds, bound)."""
    nbytes = 2 * 4 * batch * frames * channels
    flops = 3 * frames * (3 * arcs + 2 * states)
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_flops = flops / PEAKS["float32_flops"]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def union_seconds(intervals):
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def idle_gaps(intervals, start_ns, end_ns):
    """[(gap_start_ns, gap_end_ns)] inside [start_ns, end_ns] where no
    interval runs."""
    gaps, cursor = [], start_ns
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end_ns)))
        cursor = max(cursor, e)
        if cursor >= end_ns:
            break
    if cursor < end_ns:
        gaps.append((cursor, end_ns))
    return [(s, e) for s, e in gaps if e > s]
