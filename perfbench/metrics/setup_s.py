"""Set-up: process start to the first timed step (s)."""


def read(rec):
    return rec.setup_s
