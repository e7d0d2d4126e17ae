"""Experiment runtime: factories, batching, metrics, tracing, checkpoints.

Counterpart of the parts of ``gtn_applications_tpu/utils.py`` that the
RNN, TDS and TDS2d encoders and the TDS2d transducer model use with the
CTC, ASG, STC and Transducer criteria.  The batch sampler emits
width-sorted, bucketed batches, dealt to ranks as JAX's, collated by a
dataset's own ``collate_fn`` where it has one; ``Meters.sync`` sums the
metrics over the ranks; a ``Recorder``, once installed, keeps the train
and eval paths' spans, counters and CUDA-event marks; and checkpoints are
pickled ``state_dict``s or, in the collective format,
``torch.distributed.checkpoint`` directories.  The ``rnn``, ``tds``,
``tds2d`` and ``tds2d_transducer`` models and the ``ctc``, ``asg``,
``stc`` and ``transducer`` criteria resolve in the factories; a
Transducer's ``transitions`` file is read with the port's ``wfst`` graph
files.
"""

import contextlib
import importlib.util
import json
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
        """Count token and word edit distances of decoded ``predictions``
        (a ``meters`` span)."""
        with span("meters"):
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
# Tracing
# ---------------------------------------------------------------------------

# the installed Recorder, or None: tracing is off
_recorder = None
_OFF = contextlib.nullcontext()
_END = object()


class _Span:
    __slots__ = ("rec", "name", "entry")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.entry = entry = [self.name, time.perf_counter_ns(), None,
                              rec._open[-1] if rec._open else -1, rec.step]
        if rec.keep:
            rec._open.append(len(rec.spans))
            rec.spans.append(entry)
        else:
            rec._open.append(-1)
        return entry

    def __exit__(self, *exc):
        rec, entry = self.rec, self.entry
        entry[2] = time.perf_counter_ns()
        rec._open.pop()
        total = rec.totals.get(entry[0])
        if total is None:
            rec.totals[entry[0]] = [entry[2] - entry[1], 1]
        else:
            total[0] += entry[2] - entry[1]
            total[1] += 1
        return False


class Recorder:
    """Spans, counters and device marks of the train and eval paths.  A
    caller creates one and installs it (``recording``); with none
    installed, ``span``, ``mark``, ``mark_grad``, ``to_host`` and
    ``fetched`` cost one test of a module-level value.

    Each closed span adds its host time to ``totals`` (name: [ns, n]), each
    count to ``counters`` (name: n).  Marks are CUDA events recorded on the
    current stream where ``device`` is a CUDA device (no marks otherwise),
    only those named in ``marks`` where it is given, and never waited on;
    once a step's events have completed, the device ms from each of its
    marks to each later one go into ``intervals`` ((a, b): [ms, n]).

    With ``keep`` (the default) the records stay until read.  ``spans``:
    ``[name, start_ns, end_ns, parent, step]`` in opening order, on
    ``time.perf_counter_ns()``; ``parent`` is the index of the span that
    was open when it opened (-1 at the top), ``step`` the index of the
    batch it belongs to: ``fetched`` opens the next index as each batch
    arrives, so the spans of one train step or eval batch share it.
    ``counts``: ``(name, n, span, step)``, ``span`` the innermost span open
    (-1 for none).  ``marks``: ``[name, step, event]``; ``resolve()``,
    after the caller's own synchronise, turns each event into milliseconds
    from the first mark.  Without ``keep`` no span or count is kept, and
    a step's marks are folded and dropped once a later batch has arrived
    and their events have completed: what the recorder holds does not grow
    over an epoch."""

    def __init__(self, device=None, marks=None, keep=True):
        self.device_marks = device is not None and torch.device(device).type == "cuda"
        self.mark_names = None if marks is None else frozenset(marks)
        self.keep = keep
        self.spans, self.counts, self.marks = [], [], []
        self.totals, self.counters, self.intervals = {}, {}, {}
        self.step = 0
        self._open = []
        self._zero = None
        self._settled = 0   # kept marks before this index are folded

    def span(self, name):
        return _Span(self, name)

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n
        if self.keep:
            self.counts.append((name, n, self._open[-1] if self._open else -1, self.step))

    def records(self, name):
        """Whether a mark called ``name`` is recorded."""
        return self.device_marks and (self.mark_names is None or name in self.mark_names)

    def mark(self, name):
        if self.records(name):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            if self._zero is None:
                self._zero = event
            self.marks.append([name, self.step, event])

    def _settle(self, final):
        """Fold the marks of each step before the current one whose events
        have completed (with ``final``, of every step) into ``intervals``;
        kept marks become ms from the first mark, the others go."""
        marks, i = self.marks, self._settled
        while i < len(marks):
            j = i
            while j < len(marks) and marks[j][1] == marks[i][1]:
                j += 1
            if not final and (marks[i][1] == self.step
                              or not all(m[2].query() for m in marks[i:j])):
                break
            ms = [self._zero.elapsed_time(m[2]) for m in marks[i:j]]
            for a in range(j - i):
                for b in range(a + 1, j - i):
                    key = (marks[i + a][0], marks[i + b][0])
                    total = self.intervals.setdefault(key, [0.0, 0])
                    total[0] += ms[b] - ms[a]
                    total[1] += 1
            for m, t in zip(marks[i:j], ms):
                m[2] = t
            i = j
        if self.keep:
            self._settled = i
        else:
            del marks[:i]

    def resolve(self):
        """Fold every mark (call after a synchronise: each event must have
        completed)."""
        self._settle(True)
        return self

    def fetch(self, it):
        """``next(it)`` (``_END`` once spent), its wait a ``fetch`` span; a
        batch that arrives opens the next step index, its fetch included."""
        with self.span("fetch") as entry:
            item = next(it, _END)
        if item is not _END:
            self.step += 1
            entry[4] = self.step
            if not self.keep and self.marks:
                self._settle(False)
        return item

    def mean_ms(self, name):
        """Mean host ms of the spans called ``name``, or None if none."""
        total = self.totals.get(name)
        return total[0] / total[1] / 1e6 if total else None

    def mark_ms(self, a, b):
        """Mean device ms from mark ``a`` to mark ``b`` over the folded
        steps that hold both, or None if none."""
        total = self.intervals.get((a, b))
        return total[0] / total[1] if total else None


def span_path(spans, i):
    """The names from the top span down to ``spans[i]`` (spans as
    ``Recorder.spans`` holds them), joined by /."""
    names = []
    while i >= 0:
        names.append(spans[i][0])
        i = spans[i][3]
    return "/".join(reversed(names))


@contextlib.contextmanager
def recording(recorder):
    """Install ``recorder`` for the body of a ``with`` (nested installs
    restore the one before)."""
    global _recorder
    saved, _recorder = _recorder, recorder
    try:
        yield recorder
    finally:
        _recorder = saved


def span(name):
    """A ``with`` block recorded as a span called ``name``."""
    rec = _recorder
    return _OFF if rec is None else _Span(rec, name)


def mark(name):
    """A device mark called ``name`` at this point of the current stream."""
    rec = _recorder
    if rec is not None:
        rec.mark(name)


def mark_grad(tensor, name):
    """A device mark called ``name`` where backward has formed the
    gradient of ``tensor`` (a hook on it, registered only where the
    recorder records that mark)."""
    rec = _recorder
    if rec is not None and rec.records(name) and tensor.requires_grad:
        tensor.register_hook(lambda grad: rec.mark(name))


def to_host(tensor):
    """``tensor.cpu()``: a blocking read of the device, recorded as a
    ``sync`` span and a count of ``syncs``."""
    rec = _recorder
    if rec is None:
        return tensor.cpu()
    rec.count("syncs")
    with _Span(rec, "sync"):
        return tensor.cpu()


def fetched(iterable):
    """The items of ``iterable``; with a recorder, each wait a ``fetch``
    span that opens the item's step index (``Recorder.fetch``)."""
    it = iter(iterable)
    while True:
        rec = _recorder
        item = next(it, _END) if rec is None else rec.fetch(it)
        if item is _END:
            return
        yield item


def trace_clock(name):
    """A ``record_function(name)`` annotation for a profiler's trace, run
    twice (the first call is slow); returns the ``perf_counter_ns()`` at
    the middle of the second, for ``add_spans_to_trace``."""
    for _ in range(2):
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(name):
            pass
        t1 = time.perf_counter_ns()
    return (t0 + t1) // 2


def add_spans_to_trace(path, recorder, clocks_ns, clock_name):
    """Append ``recorder``'s kept spans to the Chrome trace at ``path`` that
    ``torch.profiler`` exported, on its time axis.  ``clocks_ns``: what
    ``trace_clock(clock_name)`` returned, in order, at least once; each
    pairs with the middle of its second annotation in the trace, and two
    or more fit the trace's clock as a line in ``perf_counter_ns()`` (the
    two clocks drift apart by some 1e-4)."""
    with open(path) as fid:
        trace = json.load(fid)
    events = trace["traceEvents"]
    marks = sorted(e["ts"] + e["dur"] / 2 for e in events
                   if e.get("name") == clock_name and e.get("cat") == "user_annotation")
    xs, ys = [c / 1e3 for c in clocks_ns], marks[1::2]
    slope = (ys[-1] - ys[0]) / (xs[-1] - xs[0]) if len(xs) > 1 else 1.0
    to_us = lambda ns: ys[0] + slope * (ns / 1e3 - xs[0])
    pid = max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for i, (name, start, end, _, step) in enumerate(recorder.spans):
        if end is not None:
            events.append({"ph": "X", "cat": "program", "name": name, "pid": pid, "tid": 0,
                           "ts": to_us(start), "dur": to_us(end) - to_us(start),
                           "args": {"step": step, "path": span_path(recorder.spans, i)}})
    with open(path, "w") as fid:
        json.dump(trace, fid)


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
