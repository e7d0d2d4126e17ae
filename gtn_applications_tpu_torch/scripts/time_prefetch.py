"""Time the train loop with ``criterion.prepare`` on a background thread
against preparing each batch in turn.

    python -m gtn_applications_tpu_torch.scripts.time_prefetch \\
        [--epochs N] [--rounds R] [--out FILE]

Trains the marginalized Transducer example's config (word decompositions:
``prepare`` builds each batch's alignment graphs on the host) through
``train.train`` on the card, its batches from ``train.prepared_batches``
(in turn) or from ``threaded_batches`` below (JAX's background thread, up
to two batches ahead), in turns: in turn, thread, thread, in turn,
``rounds`` times over.  Each epoch's train loop is timed on the host clock
from its first batch to its last step's end (the card synchronized); the
first epoch of each run is warm-up and is dropped.  Also times
``prepare`` alone on each batch.  Prints the card's name and power limit
and one JSON object: the median epoch and step time of each mode, and
the thread's gain.  Run from the root of a checkout, on a machine with a
GPU.
"""

import argparse
import json
import os
import queue
import statistics
import tempfile
import threading
import time

import torch


def threaded_batches(loader, criterion, prefetch=2):
    """``train.prepared_batches`` with ``prepare`` on a background thread,
    up to ``prefetch`` batches ahead (as JAX's); an exception on the
    thread is raised here."""
    q = queue.Queue(maxsize=prefetch)
    done = object()

    def produce():
        try:
            for inputs, widths, targets in loader:
                q.put((inputs, widths, targets, criterion.prepare(targets)))
        except BaseException as exc:  # carried to the consumer
            q.put(exc)
        q.put(done)

    worker = threading.Thread(target=produce, daemon=True)
    worker.start()
    while True:
        item = q.get()
        if item is done:
            break
        if isinstance(item, BaseException):
            worker.join()
            raise item
        yield item
    worker.join()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from .. import train as train_mod
    from .. import utils
    from ..examples import marginalized_transducer

    card = utils.card_name_and_power_limit()
    print(card, flush=True)
    in_turn = train_mod.prepared_batches
    epoch_times = {"in_turn": [], "thread": []}
    steps = []

    def timed(mode):
        batches_of = in_turn if mode == "in_turn" else threaded_batches

        def batches(loader, criterion):
            t0, n = time.perf_counter(), 0
            for item in batches_of(loader, criterion):
                n += 1
                yield item
            torch.cuda.synchronize()
            epoch_times[mode].append(time.perf_counter() - t0)
            steps.append(n)
        return batches

    workdir = tempfile.mkdtemp(prefix="prefetch_")
    cfg = os.path.join(workdir, "config.json")
    config = marginalized_transducer.make_config(workdir, args.epochs)
    with open(cfg, "w") as fid:
        json.dump(config, fid)
    order = ["in_turn", "thread", "thread", "in_turn"] * args.rounds
    try:
        for mode in order:
            train_mod.prepared_batches = timed(mode)
            start = len(epoch_times[mode])
            train_mod.train(train_mod.parse_args(
                ["--config", cfg, "--checkpoint_path", workdir]))
            del epoch_times[mode][start]  # warm-up epoch
    finally:
        train_mod.prepared_batches = in_turn

    dataset, preprocessor, criterion, _, _ = train_mod.load_experiment(config)
    loader = utils.data_loader(dataset.Dataset(None, preprocessor, "train"), config)
    prepare_s = []
    for _, _, targets in loader:
        t0 = time.perf_counter()
        criterion.prepare(targets)
        prepare_s.append(time.perf_counter() - t0)

    n_steps = steps[0]
    result = {"card": card, "config": "examples/marginalized_transducer.py",
              "order": order, "steps_per_epoch": n_steps,
              "prepare_ms_per_batch": 1e3 * statistics.median(prepare_s)}
    for mode in ("in_turn", "thread"):
        med = statistics.median(epoch_times[mode])
        result[mode] = {"epoch_ms": 1e3 * med, "step_ms": 1e3 * med / n_steps,
                        "epochs_ms": [1e3 * t for t in epoch_times[mode]]}
    result["thread_gain"] = 1 - result["thread"]["epoch_ms"] / result["in_turn"]["epoch_ms"]
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fid:
            json.dump(result, fid, indent=1)
    return result


if __name__ == "__main__":
    main()
