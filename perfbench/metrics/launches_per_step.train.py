"""Kernel launches a train step, over the profiled sub-window."""

from perfbench.metrics._common import kernels


def read(rec):
    if rec.mode != "train" or not rec.events:
        return None
    return kernels(rec) / rec.profile_steps
