"""95th percentile of the window's step periods (ms): from one step's
completion to the next's, by CUDA events recorded after each step."""

import statistics


def read(rec):
    if rec.mode != "train" or len(rec.periods_ms) < 20:
        return None
    return statistics.quantiles(rec.periods_ms, n=20, method="inclusive")[-1]
