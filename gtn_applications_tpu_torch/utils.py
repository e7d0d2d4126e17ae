"""Experiment runtime: factories, batching, metrics, timers, checkpoints.

Counterpart of the parts of ``gtn_applications_tpu/utils.py`` that the
RNN, TDS and TDS2d encoders and the TDS2d transducer model use with the
CTC, ASG, STC and Transducer criteria.  The batch sampler emits
width-sorted, bucketed batches, dealt to ranks as JAX's, collated by a
dataset's own ``collate_fn`` where it has one; ``Meters.sync`` sums the
metrics over the ranks; timers synchronise the CUDA device before reading the
clock; and checkpoints are pickled ``state_dict``s or, in the collective
format, ``torch.distributed.checkpoint`` directories.  The ``rnn``, ``tds``,
``tds2d`` and ``tds2d_transducer`` models and the ``ctc``, ``asg``,
``stc`` and ``transducer`` criteria resolve in the factories; a
Transducer's ``transitions`` file is read with the port's ``wfst`` graph
files.
"""

import importlib.util
import logging
import os
import pickle
import queue
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .criterions.common import round_up


# ---------------------------------------------------------------------------
# Edit distance
# ---------------------------------------------------------------------------


def edit_distance(a, b) -> int:
    """Levenshtein distance over any two sequences: by the native DP
    (``wfst.native.edit_distance_i32``, the items mapped to ids) where the
    library is enabled, as in JAX, else in Python."""
    from .wfst import native

    a, b = list(a), list(b)
    if native.enabled():
        ids = {}
        return native.edit_distance_i32(
            np.asarray([ids.setdefault(x, len(ids)) for x in a], dtype=np.int32),
            np.asarray([ids.setdefault(x, len(ids)) for x in b], dtype=np.int32))
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def compute_edit_distance(predictions, targets, preprocessor):
    """Token and word edit distances."""
    tokens_dist = words_dist = n_tokens = n_words = 0
    for p, t in zip(predictions, targets):
        p = preprocessor.tokens_to_text(p)
        t = preprocessor.to_text(t)
        pw = list(filter(None, p.split(preprocessor.wordsep)))
        tw = list(filter(None, t.split(preprocessor.wordsep)))
        tokens_dist += edit_distance(p, t)
        words_dist += edit_distance(pw, tw)
        n_tokens += len(t)
        n_words += len(tw)
    return tokens_dist, words_dist, n_tokens, n_words


# ---------------------------------------------------------------------------
# Data loading
# ---------------------------------------------------------------------------


def module_from_file(module_name, file_path):
    """Import a module by path and register it (the standard library's
    importlib recipe)."""
    spec = importlib.util.spec_from_file_location(module_name, file_path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def sample_sizes(self):
        sizes = list(self.dataset.sample_sizes())
        for idx in self.indices:
            yield sizes[idx]

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    @property
    def collate_fn(self):
        """The dataset's own collate (iamdb's ``fast_pipeline``), if any."""
        return getattr(self.dataset, "collate_fn", None)

    def __len__(self):
        return len(self.indices)


class BatchSortedSampler:
    """Width-sorted batching with rank dealing.

    Samples are sorted by input width and grouped into local batches of
    ``batch_size // world_size``, and chunk ``rank + i * world_size`` is
    dealt to each rank, as JAX's sampler deals them: the ranks' i-th
    batches together are the one-rank sampler's i-th batch.  Shuffling
    permutes the batch order only (every rank draws the same permutation
    from ``seed``), preserving the width homogeneity that keeps padding
    low.
    """

    def __init__(self, dataset, batch_size, world_rank=0, world_size=1, shuffle=True,
                 seed=0):
        local_batchsize = batch_size // world_size
        widths = (in_size[0] for in_size, _ in dataset.sample_sizes())
        sorted_indices = [
            i for i, _ in sorted(enumerate(widths), key=lambda x: x[1])
        ]
        chunks = [sorted_indices[i:i + local_batchsize]
                  for i in range(0, len(sorted_indices), local_batchsize)]
        # deal chunk (rank + i * world_size) to this rank
        self.length = len(chunks) // world_size
        self.batches = chunks[world_rank::world_size][: self.length]
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        order = (
            self._rng.permutation(self.length) if self.shuffle else range(self.length)
        )
        return (self.batches[i] for i in order)

    def __len__(self):
        return self.length


def padding_collate(samples, width_multiple=16):
    """Zero-pad inputs to a bucketed max width and stack.

    Returns (inputs [B, H, W] float32 numpy, input_widths [B], targets
    list).
    """
    inputs, targets = zip(*samples)
    h = inputs[0].shape[0]
    max_w = round_up(max(ip.shape[1] for ip in inputs), width_multiple)
    batch = np.zeros((len(inputs), h, max_w), dtype=np.float32)
    widths = np.zeros((len(inputs),), dtype=np.int32)
    for e, ip in enumerate(inputs):
        batch[e, :, : ip.shape[1]] = ip
        widths[e] = ip.shape[1]
    return batch, widths, list(targets)


class DataLoader:
    """Sampler -> padded numpy batches, with up to two batches built ahead
    on a background thread so host data work overlaps device steps.  A
    producer exception is re-raised at the consumer.  Batches are collated
    by ``collate_fn``, ``padding_collate`` unless given."""

    PREFETCH = 2

    def __init__(self, dataset, sampler, collate_fn=None):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn or padding_collate

    def _build(self, batch_indices):
        return self.collate_fn([self.dataset[i] for i in batch_indices])

    class _Raise:
        def __init__(self, exc):
            self.exc = exc

    def __iter__(self):
        q = queue.Queue(maxsize=self.PREFETCH)
        done = object()

        def produce():
            try:
                for batch_indices in self.sampler:
                    q.put(self._build(batch_indices))
            except Exception as exc:  # carried to the consumer
                q.put(DataLoader._Raise(exc))
            q.put(done)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, DataLoader._Raise):
                worker.join()
                raise item.exc
            yield item
        worker.join()

    def __len__(self):
        return len(self.sampler)


def data_loader(dataset, config, world_rank=0, world_size=1, seed=0):
    num_samples = config["data"].get("num_samples", None)
    if num_samples is not None:
        logging.info(f"Using {num_samples} of {len(dataset)}.")
        rng = np.random.RandomState(seed)
        dataset = Subset(dataset, rng.permutation(len(dataset))[:num_samples])
    return DataLoader(
        dataset,
        BatchSortedSampler(dataset, config["optim"]["batch_size"], world_rank,
                           world_size, seed=seed),
        # a dataset's own collate (iamdb's fast_pipeline) before the default
        collate_fn=getattr(dataset, "collate_fn", None),
    )


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@dataclass
class Meters:
    loss: float = 0.0
    num_samples: int = 0
    num_tokens: int = 0
    edit_distance_tokens: int = 0
    num_words: int = 0
    edit_distance_words: int = 0

    def sync(self, group=None):
        """Sum the six counts over the ranks of ``group`` (the world by
        default): one all-reduce of a float32 vector, JAX's precision
        (its ``process_allgather`` of float32 values, summed)."""
        from .parallel import mesh

        vals = torch.tensor(
            [self.loss, self.num_samples, self.num_tokens,
             self.edit_distance_tokens, self.num_words, self.edit_distance_words],
            dtype=torch.float32,
        )
        (
            self.loss,
            self.num_samples,
            self.num_tokens,
            self.edit_distance_tokens,
            self.num_words,
            self.edit_distance_words,
        ) = mesh.all_reduce(vals, group).tolist()

    # derived rates: zero-safe, error rates in percent
    @staticmethod
    def _rate(total, count, scale=1.0):
        return scale * total / count if count > 0 else 0

    @property
    def avg_loss(self):
        return self._rate(self.loss, self.num_samples)

    def add_decodes(self, predictions, targets, preprocessor):
        """Count token and word edit distances of decoded ``predictions``."""
        td, wd, nt, nw = compute_edit_distance(predictions, targets, preprocessor)
        self.edit_distance_tokens += td
        self.num_tokens += nt
        self.edit_distance_words += wd
        self.num_words += nw

    @property
    def cer(self):
        return self._rate(self.edit_distance_tokens, self.num_tokens, 100.0)

    @property
    def wer(self):
        return self._rate(self.edit_distance_words, self.num_words, 100.0)


# ---------------------------------------------------------------------------
# Timers
# ---------------------------------------------------------------------------


class Timer:
    """Host-clock phase timers; ``stop(key, sync=True)`` first waits for
    the CUDA device so that the phase includes its device work."""

    def __init__(self, keys):
        self.keys = keys
        self.reset()

    def start(self, key):
        self.running_time[key] = time.perf_counter()
        return self

    def stop(self, key, sync=False):
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.total_time[key] += time.perf_counter() - self.running_time[key]
        self.n[key] += 1
        self.running_time[key] = None
        return self

    def reset(self):
        self.total_time = {k: 0.0 for k in self.keys}
        self.running_time = {k: None for k in self.keys}
        self.n = {k: 0 for k in self.keys}
        return self

    def value(self):
        """Mean seconds per start/stop pair, for phases that ever ran."""
        vals = {
            k: self.total_time[k] / self.n[k] for k in self.keys if self.n[k]
        }
        if not vals:
            raise ValueError("Trying to divide by zero in TimeMeter")
        return vals


def card_name_and_power_limit():
    """The first GPU's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: a card
    set below its maximum power runs slower, so every time kept names it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def load_model(model_type, input_size, output_size, config, generator=None):
    """Model factory: ``rnn``, ``tds``, ``tds2d`` and ``tds2d_transducer``,
    their parameters drawn from ``generator``.  An optional ``"dtype"``
    (``"bfloat16"`` or ``"float32"``) sets the compute dtype of the TDS
    encoders, as in JAX: bf16 activations with fp32 parameters and fp32
    logits; the RNN and the transducer model ignore it."""
    from .models import RNN, TDS, TDS2d, TDS2dTransducer

    config = dict(config)
    dtype = config.pop("dtype", None)
    if dtype is not None and model_type in ("tds", "tds2d"):
        # as JAX reads the key: any other value computes in fp32
        config["dtype"] = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kwargs = dict(input_size=input_size, output_size=output_size,
                  generator=generator, **config)
    if model_type == "rnn":
        return RNN(**kwargs)
    if model_type == "tds":
        return TDS(**kwargs)
    if model_type == "tds2d":
        return TDS2d(**kwargs)
    if model_type == "tds2d_transducer":
        return TDS2dTransducer(**kwargs)
    raise ValueError(f"Unknown model type {model_type}")


def load_criterion(criterion_type, preprocessor, config):
    """Criterion factory: (criterion, model output size).  ``ctc``,
    ``asg``, ``stc`` and ``transducer`` (full n-gram, no transitions, or a
    transition graph loaded from the binary file ``transitions`` names)
    are ported."""
    from .criterions import ASG, CTC, STC, Transducer

    num_tokens = preprocessor.num_tokens
    if criterion_type == "asg":
        num_replabels = config.get("num_replabels", 0)
        use_garbage = config.get("use_garbage", True)
        return (
            ASG(num_tokens, num_replabels, use_garbage),
            num_tokens + num_replabels + int(use_garbage),
        )
    if criterion_type == "ctc":
        # ``use_pt`` is accepted and ignored: the port's CTC runs on its own
        # kernels either way
        return (
            CTC(num_tokens, config.get("use_pt", True), config.get("impl", "auto"),
                config.get("chunk", None)),
            num_tokens + 1,
        )
    if criterion_type == "stc":
        # the model emits [blank, tokens...]; star channels are internal.
        # The class defaults to reduction "none", the factory to "mean".
        return (
            STC(
                blank_idx=0,
                p0=config.get("p0", 1.0),
                plast=config.get("plast", 1.0),
                thalf=config.get("thalf", 1.0),
                reduction=config.get("reduction", "mean"),
                shift_targets=1,
            ),
            num_tokens + 1,
        )
    if criterion_type == "transducer":
        blank = config.get("blank", "none")
        transitions = config.get("transitions")
        if transitions is not None:
            from .wfst import graph as wgraph

            transitions = wgraph.load(transitions)
        criterion = Transducer(
            preprocessor.tokens, preprocessor.graphemes_to_index,
            ngram=config.get("ngram", 0), transitions=transitions, blank=blank,
            allow_repeats=config.get("allow_repeats", True), reduction="mean",
        )
        return criterion, num_tokens + int(blank != "none")
    raise ValueError(f"Unknown criterion type {criterion_type}")


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


DCP_DIR = "model.dcp"


def save_checkpoint(checkpoint_path, state, save_best=False, format="pickle"):
    """Persist the train state (``state_dict``s and counters).

    ``format="pickle"`` pickles it on the host into ``model.checkpoint``
    (and ``model.checkpoint.best``); the caller saves from rank 0 only.
    ``format="orbax"``, JAX's collective per-host format, is
    ``torch.distributed.checkpoint`` here: every rank calls it and writes
    its part into the directory ``model.dcp`` (and ``model.dcp.best``)."""
    os.makedirs(checkpoint_path, exist_ok=True)
    if format == "orbax":
        import torch.distributed.checkpoint as dcp

        payload = _to_cpu(state)
        for suffix in ("", ".best") if save_best else ("",):
            path = os.path.join(checkpoint_path, DCP_DIR + suffix)
            dcp.save(payload, storage_writer=dcp.FileSystemWriter(path, overwrite=True))
        return
    if format != "pickle":
        raise ValueError(f"unknown checkpoint format {format!r}")
    payload = _to_cpu(state)
    path = os.path.join(checkpoint_path, "model.checkpoint")
    with open(path, "wb") as fid:
        pickle.dump(payload, fid)
    if save_best:
        with open(path + ".best", "wb") as fid:
            pickle.dump(payload, fid)


def load_checkpoint(checkpoint_path, load_last=False, template=None):
    """Load a train state written by ``save_checkpoint``, detecting its
    format.  A ``torch.distributed.checkpoint`` directory is read into
    ``template`` (a state of the same structure, e.g. the current model's,
    which every rank passes) and returned; a pickle needs none.  Only load
    checkpoints this program wrote: unpickling runs code."""
    suffix = "" if load_last else ".best"
    dcp_path = os.path.join(checkpoint_path, DCP_DIR + suffix)
    if os.path.isdir(dcp_path):
        if template is None:
            raise ValueError(f"{dcp_path} is a torch.distributed.checkpoint: pass the "
                             "state to load it into as template")
        import torch.distributed.checkpoint as dcp

        dcp.load(template, checkpoint_id=dcp_path)
        return template
    path = os.path.join(checkpoint_path, "model.checkpoint" + suffix)
    with open(path, "rb") as fid:
        return pickle.load(fid)


def load_from_checkpoint(checkpoint_path, load_last=False, template=None):
    """The (model ``state_dict``, criterion parameters) pair of a saved
    train state."""
    state = load_checkpoint(checkpoint_path, load_last, template)
    return state["model"], state["criterion"]
