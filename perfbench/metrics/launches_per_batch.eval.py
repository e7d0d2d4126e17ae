"""Kernel launches an evaluated batch, over the profiled pass."""

from perfbench.metrics._common import kernels


def read(rec):
    if rec.mode != "eval" or not rec.events:
        return None
    return kernels(rec) / rec.profile_steps
