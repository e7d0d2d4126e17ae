"""The benchmark of ``gtn_applications_tpu_torch``: one cell a run.

A cell of ``BENCHMARK.json`` names a configuration file
(``perfbench/configs/<config>.json``: a reference recipe as it stands and
the name of its plain reference under ``perfbench/reference/``) and a
traffic file (``perfbench/traffic/<traffic>.json``, read by the
generator it names, ``perfbench/generators/<generator>.py``), and its
correctness limits sit in
``perfbench/limits/<workload>.json``.  Each metric is the ``read(record)``
of ``perfbench/metrics/<name>.py``; a reader that finds nothing returns
None and the metric is left out.  A cell that ``BENCHMARK.json`` does not
list is looked up in ``perfbench/parked.json``: cells measured and left
out, which run by name all the same.

A run builds the port's objects as ``train.train`` builds them (its
preprocessor, criterion, model, ``utils.data_loader`` over the
generator's dataset),
loads weights the benchmark draws from the seed, and warms every batch
shape by one pass over the corpus.  A train cell's pass is the first
epoch of training, whose first three steps the reference follows; an
eval cell's is one ``train.evaluate`` pass.  The window then cycles
epochs until ``--seconds`` have passed, and ends at a synchronise.  With
``--trace 1`` the window records host spans, and after it a profiled
sub-window and the layers timed alone give the per-layer metrics.  Once
the window has closed and the program is freed, the reference checks
what the timed path produced.
"""

import bisect
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from . import traffic as traffic_mod
from . import yardstick

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "gtn_applications_tpu")
CHECK_STEPS = 3


def now():
    return time.perf_counter_ns()


def banned_modules(names=None):
    """The banned top-level names among loaded modules, each compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def _merge(base, extra):
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits, reference and metrics."""

    def __init__(self, name, root=ROOT, overrides=None):
        self.root = Path(root)
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        if name not in {w["name"] for w in spec["workloads"]}:
            # a cell measured and left out, with its own metric entries
            spec = json.loads((self.root / "perfbench/parked.json").read_text())
        self.spec = spec
        self.workload = next(w for w in spec["workloads"] if w["name"] == name)
        self.name = name
        config = next(c for c in spec["configs"] if c["name"] == self.workload["config"])
        overrides = overrides or {}
        self.cfg = _merge(json.loads((self.root / config["file"]).read_text()),
                          overrides.get("config"))
        self.traffic = _merge(
            traffic_mod.load(self.root / "perfbench/traffic" / f"{self.workload['traffic']}.json"),
            overrides.get("traffic"))
        self.mode = self.traffic["mode"]
        limits = self.root / "perfbench/limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text())
        self.reference = _load_module(
            self.root / "perfbench/reference" / f"{self.cfg['reference']}.py",
            f"perfbench_reference_{self.cfg['reference']}")

    def metrics(self, trace):
        """The cell's metric entries for a run with or without the trace."""
        entries = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in entries if self.name in m.get("workloads", [self.name])]

    def reader(self, metric):
        path = self.root / "perfbench/metrics" / f"{metric}.py"
        return _load_module(path, "perfbench_metric_" + metric.replace(".", "_")).read


# ---------------------------------------------------------------------------
# The program under test
# ---------------------------------------------------------------------------


class Program:
    """The port's objects for one run, built as ``train.train`` builds
    them, over the benchmark's corpus and weights."""

    def __init__(self, cell, corpus, task, seed, device):
        from gtn_applications_tpu_torch import train as ptrain
        from gtn_applications_tpu_torch import utils as putils
        from gtn_applications_tpu_torch.datasets.text import TextPreprocessor

        cfg = cell.cfg
        self.ptrain, self.putils = ptrain, putils
        self.cfg, self.device, self.task, self.corpus = cfg, device, task, corpus
        tokens = cfg.get("tokens_file")
        pre = TextPreprocessor(["".join(corpus.chars)],
                               tokens_path=None if tokens is None else str(cell.root / tokens),
                               prepend_wordsep=cfg["data"].get("prepend_wordsep", False))
        pre.num_features = cfg["data"]["num_features"]
        self.preprocessor = pre
        self.criterion, out_size = putils.load_criterion(
            cfg.get("criterion_type", "ctc"), pre, cfg.get("criterion", {}))
        self.model = putils.load_model(cfg["model_type"], pre.num_features, out_size,
                                       cfg["model"], generator=torch.Generator().manual_seed(0))
        self.w0 = task.make_weights(seed, device)
        self.model.load_state_dict(task.views(self.w0.clone()), strict=True)
        self.model.to(device)
        ptrain.criterion_to_device(self.criterion, device)
        self.mesh = ptrain.make_mesh(cfg["optim"].get("seq_parallel", 1))

        self.dataset = traffic_mod.make_dataset(cell.traffic, cell.root, corpus, pre)
        self.loader = putils.data_loader(self.dataset, cfg, 0, 1, seed % 2**32)
        self.loader.sampler = _Recording(self.loader.sampler)
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.gen_state0 = self.gen.get_state()
        self.use_lengths = cfg["optim"].get("use_input_lengths", False)

    def chunks(self):
        """Every batch of the corpus, as the sampler groups it."""
        return self.loader.sampler.inner.batches

    def params(self):
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}


class _Recording:
    """A sampler that records the order of the batches it deals."""

    def __init__(self, inner):
        self.inner = inner
        self.order = []

    def __iter__(self):
        for batch in self.inner:
            self.order.append(batch)
            yield batch

    def __len__(self):
        return len(self.inner)


class TrainLoop:
    """``train.train``'s epoch loop, a step at a time: prepared batches,
    the device copy, the train step, and the per-step decode and meters."""

    def __init__(self, prog):
        self.p = prog
        optim = prog.cfg["optim"]
        pt = prog.ptrain
        lr = optim["learning_rate"]
        self.lr = lr
        self.step_fn = pt.make_train_step(
            prog.model, prog.criterion, lr, optim.get("crit_learning_rate", lr),
            optim.get("max_grad_norm", None), prog.mesh.group("data"), prog.mesh.group("seq"))
        self.metrics_interval = optim.get("metrics_interval", 1)
        self.step_size = optim["step_size"]
        self.meters = prog.putils.Meters()
        self.losses = []
        self.spans = None
        self.lr_scale = 1.0
        self.stream = self._stream()

    def _stream(self):
        epoch = 0
        while True:
            self.lr_scale = 0.5 ** (epoch // self.step_size)
            self.p.criterion.train()
            yield from enumerate(self.p.ptrain.prepared_batches(self.p.loader, self.p.criterion))
            epoch += 1

    def step(self):
        """One step; returns (widths, loss, predictions or None)."""
        p, pt, crit = self.p, self.p.ptrain, self.p.criterion
        t0 = now()
        step_idx, (inputs, widths, targets, prepared) = next(self.stream)
        t1 = now()
        time_axis = pt.input_time_axis(inputs, p.preprocessor.num_features)
        inputs, time_axis = pt.shard_time(pt.shard_batch(inputs, p.mesh, time_axis), p.mesh,
                                          time_axis, p.model)
        inputs, prepared = pt._to_device(inputs, prepared, p.device)
        lens = pt.output_lengths(p.model, widths).to(p.device) if p.use_lengths else None
        t2 = now()
        loss, outputs = self.step_fn(inputs, prepared, p.gen, self.lr_scale, lens, time_axis)
        t3 = now()
        self.losses.append(loss * len(targets))
        self.meters.num_samples += len(targets)
        predictions = None
        t4 = t3
        if step_idx % self.metrics_interval == 0:
            predictions = crit.viterbi_finalize(crit.viterbi_dispatch(outputs, crit.params, lens))
            t4 = now()
            self.meters.add_decodes(predictions, targets, p.preprocessor)
        if self.spans is not None:
            t5 = now()
            self.spans += [("fetch", t0, t1), ("to_device", t1, t2), ("step", t2, t3),
                           ("decode", t3, t4), ("meters", t4, t5)]
        return widths, loss, predictions


def first_steps(loop, prog, n=CHECK_STEPS):
    """The first ``n`` steps of a fresh train loop, with what the check
    reads of them: the losses, the first step's decodes, the parameters
    after the first and the last, the batches and the starting state."""
    out = {"losses": [], "predictions": []}
    for k in range(n):
        _, loss, preds = loop.step()
        out["losses"].append(loss)
        out["predictions"].append(preds)
        if k == 0:
            out["p1"] = prog.params()
    out["p3"] = prog.params()
    out["losses"] = [float(v) for v in out["losses"]]
    out["chunks"] = prog.loader.sampler.order[:n]
    out["lr"] = loop.lr * loop.lr_scale
    out["w0"], out["gen_state0"] = prog.w0, prog.gen_state0
    return out


class _TimedIter:
    """A loader whose batches' waits are host spans named ``fetch``."""

    def __init__(self, loader, spans):
        self.loader, self.spans = loader, spans

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = now()
            try:
                item = next(it)
            except StopIteration:
                return
            self.spans.append(("fetch", t0, now()))
            yield item


def _timed(fn, name, spans):
    def wrapper(*args, **kwargs):
        t0 = now()
        out = fn(*args, **kwargs)
        spans.append((name, t0, now()))
        return out
    return wrapper


class EvalLoop:
    """``train.evaluate``, a pass over the corpus a call, keeping each
    batch's loss (as the eval step returns it) and decodes."""

    def __init__(self, prog):
        self.p = prog
        self.spans = None
        step = prog.ptrain.make_eval_step(prog.model, prog.criterion, prog.mesh.group("seq"))
        self.losses = []

        def eval_step(*args, **kwargs):
            loss, outputs = step(*args, **kwargs)
            self.losses.append(loss)
            return loss, outputs

        self.eval_step = eval_step

    def epoch(self):
        """One pass: (meters, [(chunk, loss, predictions)])."""
        p = self.p
        p.criterion.eval()
        decodes = []
        self.losses = []
        order = p.loader.sampler.order
        start = len(order)
        loader = p.loader if self.spans is None else _TimedIter(p.loader, self.spans)
        meters = p.ptrain.evaluate(
            p.model, p.criterion, loader, p.preprocessor, self.eval_step, p.device,
            p.use_lengths, report=lambda preds, targets: decodes.append(preds))
        return meters, list(zip(order[start:start + len(decodes)], self.losses, decodes))


def instrument(prog, loop, spans):
    """Host spans from here on: ``prepare`` always; the train loop's own
    phases, or around ``evaluate``'s calls (the loader's waits, the eval
    step's enqueue, the decode)."""
    crit = prog.criterion
    crit.prepare = _timed(crit.prepare, "prepare", spans)
    loop.spans = spans
    if isinstance(loop, EvalLoop):
        crit.viterbi_dispatch = _timed(crit.viterbi_dispatch, "decode", spans)
        crit.viterbi_finalize = _timed(crit.viterbi_finalize, "decode", spans)
        loop.eval_step = _timed(loop.eval_step, "step", spans)


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------


def _ns(event, what):
    fn = getattr(event, f"{what}_ns", None)
    return fn() if fn is not None else int(getattr(event, f"{what}_us")() * 1000)


def profiled(run):
    """Run ``run()`` under ``torch.profiler`` (device activity only, so the
    host's pace is not slowed) and return (device events [(name, start,
    end)], window (start, end), offset): times in the profiler's clock, and
    the offset that maps ``now()`` onto it, read from a marker kernel
    launched on an idle device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    t_mark = now()
    torch.cuda._sleep(1000)
    run()
    torch.cuda.synchronize()
    t_end = now()
    prof.stop()
    events = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = _ns(e, "start")
        events.append((e.name(), start, start + _ns(e, "duration")))
    events.sort(key=lambda e: e[1])
    if not events:
        return [], (0, 0), 0
    marker = events[0]
    offset = marker[1] - t_mark
    return events[1:], (marker[2], t_end + offset), offset


def breakdown(events, window, spans, offset):
    """The device operations that took most time, and the idle gaps by
    the host span that was running at each gap's middle."""
    by_op = {}
    for name, s, e in events:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    gaps = yardstick.idle_gaps([(s, e) for _, s, e in events], *window)
    host = sorted((s + offset, e + offset, n) for n, s, e in spans)
    starts = [h[0] for h in host]
    by_span = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = host[i][2] if i >= 0 and host[i][1] >= mid else "outside spans"
        by_span[name] = by_span.get(name, 0.0) + (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


class Record:
    """What the metrics' readers read."""

    def __init__(self, mode):
        self.mode = mode
        self.setup_s = None
        self.window_s = None
        self.steps = 0            # train steps, or eval batches, in the window
        self.lines = 0
        self.periods_ms = []      # train: each step's period
        self.window_flops = 0.0   # model FLOPs of the window's lines
        self.spans = []           # (name, start_ns, end_ns), the window's first
        self.window_spans = 0     # how many of the spans are the window's
        self.events = []          # device (name, start, end) of the profiled sub-window
        self.profile_window = None
        self.profile_steps = 0
        self.encoder_ms = []
        self.criterion_ms = []
        self.criterion_least_s = []


def run(cell, seed, seconds, trace, device, t_start=None, log=None):
    """One run of ``cell``; returns the result line's dict (without the
    banned-module check, which the caller makes last).  ``log``, if given,
    receives the set-up's phases as text."""
    t_start = now() if t_start is None else t_start
    phase = [t_start]

    def mark(name):
        if log is not None:
            log(f"setup {name} {(now() - phase[0]) / 1e9:.3f} s")
        phase[0] = now()

    mark("imports")
    on_cuda = device.type == "cuda"
    corpus = traffic_mod.make_corpus(cell.traffic, seed, cell.root)
    mark("corpus")
    task = cell.reference.Task(cell.cfg, corpus.chars, cell.root)
    prog = Program(cell, corpus, task, seed, device)
    mark("program")
    rec = Record(cell.mode)
    train = cell.mode == "train"
    factor = 3 if train else 1

    # set-up: the first epoch, whose first steps the reference follows
    if train:
        loop = TrainLoop(prog)
        readings = first_steps(loop, prog)
        for _ in range(len(prog.loader) - CHECK_STEPS):
            loop.step()
    else:
        loop = EvalLoop(prog)
        loop.epoch()
    if trace:
        instrument(prog, loop, rec.spans)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mark("warm pass")
    rec.setup_s = (now() - t_start) / 1e9

    # the window
    events = [] if on_cuda else None
    window_widths = []
    t0 = now()
    if on_cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    deadline = t0 + int(seconds * 1e9)
    last_eval = None
    if train:
        step_losses = []
        while now() < deadline:
            widths, loss, _ = loop.step()
            window_widths.append(widths)
            step_losses.append(loss)
            if on_cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            rec.steps += 1
            rec.lines += len(widths)
    else:
        while now() < deadline:
            meters, decodes = loop.epoch()
            last_eval = (meters, decodes)
            rec.steps += len(decodes)
            rec.lines += meters.num_samples
            window_widths += [[corpus.images[i].shape[-1] for i in c] for c, _, _ in decodes]
    if on_cuda:
        torch.cuda.synchronize()
    rec.window_s = (now() - t0) / 1e9
    rec.window_spans = len(rec.spans)
    if train:
        n_bad = sum(not math.isfinite(v) for v in torch.stack(step_losses).tolist())
    else:
        last_eval = [(c, float(loss), preds) for c, loss, preds in last_eval[1]]
        n_bad = sum(not math.isfinite(loss) for _, loss, _ in last_eval)
    if on_cuda:
        rec.periods_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    rec.window_flops = factor * sum(task.forward_flops(int(w)) for ws in window_widths
                                    for w in ws)
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0

    result_device = device_info(device)
    result_device["memory_peak_bytes"] = memory_peak
    result = {"attempted": rec.steps, "failed": n_bad}
    if trace:
        result["breakdown"] = trace_layers(cell, prog, loop, rec, task, device)
        result_device["busy_s"] = yardstick.union_seconds([(s, e) for _, s, e in rec.events])
        result_device["window_s"] = ((rec.profile_window[1] - rec.profile_window[0]) / 1e9
                                     if rec.profile_window else 0.0)

    # the check, once the program's state is freed
    if not train:
        readings = {"w0": prog.w0, "batches": last_eval}
    del loop, prog
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    checks = check(cell, task, corpus, readings, device)
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values()) and n_bad == 0
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = result_device
    result["checks"] = checks
    return result


def device_info(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


# ---------------------------------------------------------------------------
# The traced run's per-layer measurements
# ---------------------------------------------------------------------------


def trace_layers(cell, prog, loop, rec, task, device):
    """The profiled sub-window (``profile_steps`` train steps or one eval
    pass) and each layer timed alone over every batch of the corpus."""
    if device.type != "cuda":
        return {"device_ops": [], "idle_gaps": []}
    if cell.mode == "train":
        n = cell.traffic["profile_steps"]

        def go():
            for _ in range(n):
                loop.step()
    else:
        n = len(prog.loader)

        def go():
            loop.epoch()
    rec.events, rec.profile_window, offset = profiled(go)
    rec.profile_steps = n
    out = breakdown(rec.events, rec.profile_window, rec.spans[rec.window_spans:], offset)
    time_layers(cell, prog, rec, task, device)
    return out


def time_layers(cell, prog, rec, task, device):
    """CUDA events around the encoder (forward and backward for train,
    forward for eval) and, for train, the criterion's loss forward and
    backward on the encoder's logits, over each batch of the corpus."""
    pt, crit, model = prog.ptrain, prog.criterion, prog.model
    train = cell.mode == "train"
    gen = torch.Generator(device=device).manual_seed(0)
    marks = []
    for chunk in prog.chunks():
        inputs, widths, targets = prog.loader.collate_fn([prog.dataset[i] for i in chunk])
        x, prepared = pt._to_device(inputs, crit.prepare(targets), device)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if train:
            e[0].record()
            out = model(x, train=True, generator=gen)
            torch.autograd.backward(out, torch.ones_like(out))
            e[1].record()
            for p in model.parameters():
                p.grad = None
            logits = out.detach().requires_grad_(True)
            e[2].record()
            loss = crit.loss(crit.params, logits, prepared, None)
            loss.backward()
            e[3].record()
            T = logits.shape[1]
            states = arcs = 0
            for i in chunk:
                s, a = task.lattice_size(prog.corpus.texts[i])
                states, arcs = states + s, arcs + a
            rec.criterion_least_s.append(yardstick.criterion_least_seconds(
                len(chunk), T, logits.shape[2], states, arcs)[0])
        else:
            with torch.no_grad():
                e[0].record()
                model(x)
                e[1].record()
        marks.append(e)
    torch.cuda.synchronize()
    for e in marks:
        rec.encoder_ms.append(e[0].elapsed_time(e[1]))
        if train:
            rec.criterion_ms.append(e[2].elapsed_time(e[3]))


# ---------------------------------------------------------------------------
# The check against the plain reference
# ---------------------------------------------------------------------------


def kept_leaves(g_ref):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under the update by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in g_ref.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def train_numbers(prog, ref, keep):
    """The train cell's numbers of a program's (or the control's) first
    steps against the reference's: each step's loss and the first's, the
    first gradient's and the change's norms by the worst leaf and by the
    median leaf, and the first step's decode."""
    norm = lambda d: {n: float(torch.linalg.vector_norm(v)) for n, v in d.items()}
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": max(loss_gaps), "loss1_gap": loss_gaps[0]}
    for key in ("g1", "change"):
        p, r = norm(prog[key]), norm(ref[key])
        median = statistics.median(r[n] for n in keep)
        gaps = [abs(p[n] - r[n]) / max(r[n], median) for n in keep]
        name = "grad" if key == "g1" else "change"
        out[f"{name}_gap"] = max(gaps)
        out[f"{name}_gap_median"] = statistics.median(gaps)
        out[f"{name}_worst_leaf"] = keep[gaps.index(max(gaps))]
    out["decode_gap"] = max(ref["decode_gaps"])
    return out


def reference_train(cell, task, corpus, w0, gen_state0, chunks, device, tf32=False,
                    dtype=torch.float32):
    """The reference's first steps from the benchmark's weights and the
    same dropout stream: losses, logits, first clipped gradient, change.
    ``dtype`` float64 gives the readings that rounding is measured from."""
    R = cell.reference
    with _tf32(tf32):
        w0 = w0.to(dtype)
        w = R.views(w0.clone(), task.shapes)
        gen = torch.Generator(device=device)
        gen.set_state(gen_state0)
        out = {"losses": [], "logits": []}
        for k, chunk in enumerate(chunks):
            x = R.batch_inputs([corpus.images[i] for i in chunk], device).to(dtype)
            targets = [task.target(corpus.texts[i]) for i in chunk]
            loss, logits, clipped = R.train_step(w, task.model_cfg, task.optim_cfg, x, targets,
                                                 task.pieces, task.blank, gen)
            out["losses"].append(float(loss))
            out["logits"].append(logits)
            if k == 0:
                out["g1"] = clipped
        w_start = R.views(w0, task.shapes)
        out["change"] = {n: w[n] - w_start[n] for n in w}
    return out


class _tf32:
    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def program_train_readings(readings, task):
    """The program's first losses, first gradient as the optimizer got it
    ((p0 - p1) / lr) and change after three steps (p3 - p0)."""
    w0 = task.views(readings["w0"])
    lr = readings["lr"]
    return {
        "losses": readings["losses"],
        "g1": {n: (w0[n] - p) / lr for n, p in readings["p1"].items()},
        "change": {n: p - w0[n] for n, p in readings["p3"].items()},
        "predictions": readings["predictions"],
    }


def reference_eval(cell, task, corpus, w0, chunks, device, tf32=False):
    """The reference's loss and logits of each of ``chunks``."""
    R = cell.reference
    losses, logits_all = [], []
    with _tf32(tf32), torch.no_grad():
        w = R.views(w0, task.shapes)
        for chunk in chunks:
            x = R.batch_inputs([corpus.images[i] for i in chunk], device)
            targets = [task.target(corpus.texts[i]) for i in chunk]
            logits = R.encoder(w, task.model_cfg, x)
            losses.append(float(R.loss(logits, targets, task.pieces, task.blank)))
            logits_all.append(logits)
    return {"losses": losses, "logits": logits_all}


def reference(cell, task, corpus, readings, device, tf32=False, dtype=torch.float32):
    """The reference over what the run's check reads: the train cell's
    first steps, or the eval cell's last pass."""
    if cell.mode == "train":
        return reference_train(cell, task, corpus, readings["w0"], readings["gen_state0"],
                               readings["chunks"], device, tf32, dtype)
    return reference_eval(cell, task, corpus, readings["w0"],
                          [c for c, _, _ in readings["batches"]], device, tf32)


def as_program(cell, task, ref):
    """A reference's readings in the program's form, its greedy decodes
    for the program's: the control."""
    R = cell.reference
    if cell.mode == "train":
        return dict(ref, predictions=[R.greedy(l, task.blank) for l in ref["logits"]])
    return {"batches": [(None, loss, R.greedy(logits, task.blank))
                        for loss, logits in zip(ref["losses"], ref["logits"])]}


def numbers(cell, task, prog, ref):
    """Every number the check can compare: ``prog`` (the program's
    readings, ``program_train_readings`` for train) against ``ref``."""
    R = cell.reference
    if cell.mode == "train":
        # the first step's decode: later steps start from parameters that
        # rounding has already moved apart
        ref = dict(ref, decode_gaps=R.decode_gap(ref["logits"][0], prog["predictions"][0],
                                                 task.blank).tolist())
        keep = kept_leaves(ref["g1"])
        return dict(train_numbers(prog, ref, keep), leaves_left_out=len(ref["g1"]) - len(keep))
    loss_gaps, gaps = [], []
    for loss, logits, (_, p_loss, preds) in zip(ref["losses"], ref["logits"], prog["batches"]):
        loss_gaps.append(abs(p_loss - loss) / abs(loss))
        gaps += R.decode_gap(logits, preds, task.blank).tolist()
    return {"loss_gap": max(loss_gaps), "decode_gap": max(gaps)}


def check(cell, task, corpus, readings, device):
    """Each number compared, with its limit."""
    ref = reference(cell, task, corpus, readings, device)
    prog = program_train_readings(readings, task) if cell.mode == "train" else readings
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in numbers(cell, task, prog, ref).items() if k in cell.limits}
