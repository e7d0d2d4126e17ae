"""The criterion's share of its roofline (%): the least time of its
work (yardstick.criterion_least_seconds) over its CUDA-event time,
summed over the corpus's batches."""


def read(rec):
    if rec.mode != "train" or not rec.criterion_ms:
        return None
    return 100.0 * sum(rec.criterion_least_s) / (sum(rec.criterion_ms) / 1e3)
