"""A cell's run with the port's own recorder, read beside the harness's
trace.

    python3 perfbench/program_trace.py --workload NAME --seed N --seconds S \
        [--trace 1] [--recorder 1]

Runs ``bench.run`` as ``run.py`` does, with the port's recorder
(``gtn_applications_tpu_torch.utils.Recorder``) installed for the whole
run.  With ``--trace 1`` it also keeps the profiler's launch calls (the
CUDA runtime's, which its device activity records beside the kernels)
and prints the result line with a ``program`` entry: the per-layer
numbers read from the recorder, two more breakdowns and two checks (the
shared clock, and how much of the device's idle time the program's spans
cover).  ``--recorder 0 --trace 0`` is ``run.py``'s run, the other side of
what the recorder costs when it is on.

``bench.py`` does not call this module: ``run.py``'s result line reads
nothing of it.  It patches ``bench.instrument``, ``bench.trace_layers``
and ``bench.profiled`` (``profiled_with_calls`` is ``bench.profiled``
keeping the launch calls) and reads the harness's record: a second traced
path, kept only until ``bench.py`` installs the recorder and keeps the
launch calls itself, when these reductions move into ``bench.py`` and
``perfbench/metrics/`` and this module and its test go (PERF.md, Open
questions).
"""

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUTSIDE = "outside program spans"


# ---------------------------------------------------------------------------
# Reductions of the recorder's spans, counts and marks
# ---------------------------------------------------------------------------


def innermost(spans, offset=0):
    """A function of a time (the profiler's clock: ``perf_counter_ns`` +
    ``offset``) that gives the index of the innermost of ``spans`` (the
    recorder's ``[name, start, end, parent, step]``) open at it, or -1.
    The latest span to start at or before the time, or one of its
    ancestors, is the innermost: spans nest."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    starts = [spans[i][1] + offset for i in order]

    def find(t):
        k = bisect.bisect_right(starts, t) - 1
        i = order[k] if k >= 0 else -1
        while i >= 0 and not (spans[i][2] is not None and t < spans[i][2] + offset):
            i = spans[i][3]
        return i
    return find


def path(spans, i):
    """The names from the top span down to span ``i``, joined by /."""
    from gtn_applications_tpu_torch.utils import span_path

    return span_path(spans, i) or OUTSIDE


def rebase(spans, lo, hi):
    """``spans[lo:hi]`` with their parents' indices counted from ``lo``
    (-1 for a parent before it)."""
    return [[n, s, e, p - lo if p >= lo else -1, k] for n, s, e, p, k in spans[lo:hi]]


def top(d, n=12):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_span(gaps, spans, offset):
    """Idle seconds by the path of the innermost span open at each gap's
    middle."""
    find, out = innermost(spans, offset), {}
    for s, e in gaps:
        key = path(spans, find((s + e) // 2))
        out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def launches_by_span(launches, spans, offset, steps):
    """Kernels a step by the path of the innermost span open when their
    launch call started; ``launches``: (kernel name, call start)."""
    find, out = innermost(spans, offset), {}
    for name, t in launches:
        if not name.startswith(("Memcpy", "Memset")):
            key = path(spans, find(t))
            out[key] = out.get(key, 0.0) + 1.0 / steps
    return out


def inside_share(times, outer, inner):
    """Of ``times`` inside an interval of ``outer``, the share inside an
    interval of ``inner`` (None if none is inside ``outer``)."""
    def covered(t, intervals):
        return any(s <= t <= e for s, e in intervals)
    hits = [t for t in times if covered(t, outer)]
    return sum(covered(t, inner) for t in hits) / len(hits) if hits else None


def overlap_seconds(gaps, intervals):
    """Seconds of ``gaps`` that ``intervals`` (disjoint) cover."""
    return sum(max(0, min(e, ie) - max(s, i_s)) for s, e in gaps
               for i_s, ie in intervals) / 1e9


def step_marks_ms(marks, steps):
    """Per step of ``steps`` that has every mark: (encoder, criterion,
    optimizer) device ms.  The encoder runs from ``forward`` to
    ``forward.end`` and from ``outputs.grad`` (a hook on the outputs'
    gradient) to ``backward.end``; the criterion from ``forward.end`` to
    ``outputs.grad`` (its loss, then its backward); the optimizer (reduce,
    clip, SGD) from ``backward.end`` to ``optimizer.end``."""
    by_step = {}
    for name, step, ms in marks:
        if step in steps and isinstance(ms, float):
            by_step.setdefault(step, {})[name] = ms
    names = {"forward", "forward.end", "outputs.grad", "backward.end", "optimizer.end"}
    return [((m["forward.end"] - m["forward"]) + (m["backward.end"] - m["outputs.grad"]),
             m["outputs.grad"] - m["forward.end"],
             m["optimizer.end"] - m["backward.end"])
            for m in by_step.values() if names <= set(m)]


def mean(values):
    return sum(values) / len(values) if values else None


def numbers(mode, window, counts, marks, profile=None):
    """The per-layer numbers of the recorder's window (its spans and
    counts) and, with ``profile`` (spans, device events, window, offset,
    launches (kernel, call start), harness spans, profiled steps), of the
    profiled sub-window."""
    steps = [s for s in window if s[0] == "step"]
    n = len(steps)
    host_ms = lambda name: sum(e - s for nm, s, e, _, _ in window if nm == name) / 1e6 / n
    out = {}
    if n:
        if mode == "train":
            out["syncs_per_step.train"] = sum(c[1] for c in counts if c[0] == "syncs") / n
            out["meters_ms.train"] = host_ms("meters")
            per_step = step_marks_ms(marks, {s[4] for s in steps})
            if per_step:
                for k, name in enumerate(("encoder", "criterion", "optimizer")):
                    out[f"step_{name}_ms.train"] = mean([p[k] for p in per_step])
        else:
            out["sync_wait_ms.eval"] = host_ms("sync")
            out["meters_ms.eval"] = host_ms("meters")
    if profile is None:
        return out, {}
    from perfbench import yardstick

    spans, events, win, offset, launches, harness, n_prof = profile
    gaps = yardstick.idle_gaps([(s, e) for _, s, e in events], *win)
    prog_steps = [(s + offset, e + offset) for nm, s, e, _, _ in spans if nm == "step"]
    if mode == "train":
        out["step_idle_ms.train"] = 1e3 * overlap_seconds(gaps, prog_steps) / n_prof
    extra = {
        # the marks over the profiled steps: its activity tracing slows
        # each launch
        "profiled_marks_ms": dict(zip(("encoder", "criterion", "optimizer"), map(mean, zip(
            *step_marks_ms(marks, {s[4] for s in spans if s[0] == "step"}))))),
        "program_idle_gaps": idle_by_span(gaps, spans, offset),
        "program_launches": launches_by_span(launches, spans, offset, n_prof),
        "idle_s": sum(e - s for s, e in gaps) / 1e9,
        "launch_calls": len(launches),
        "clock_share": inside_share(
            [t for _, t in launches],
            [(s + offset, e + offset) for nm, s, e in harness if nm == "step"], prog_steps),
    }
    return out, extra


def coverage(mode, program_idle_gaps, idle_s, harness_idle_gaps):
    """Train: the share of the harness's ``step`` idle that the program's
    children of ``step`` hold; eval: the share of the pass's idle outside
    every program span."""
    gaps = program_idle_gaps
    if mode == "train":
        under = dict(harness_idle_gaps).get("step")
        inside = sum(v for k, v in gaps.items() if k.startswith("step/"))
        return {"step_children_share": inside / under if under else None}
    return {"outside_share": gaps.get(OUTSIDE, 0.0) / idle_s if idle_s else None}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def profiled_with_calls(bench, run, keep):
    """``bench.profiled(run)``, the same return, with the launch calls of
    its device operations (kernel name, call start) put in ``keep``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    t_mark = bench.now()
    torch.cuda._sleep(1000)
    run()
    torch.cuda.synchronize()
    t_end = bench.now()
    prof.stop()
    events, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        start = bench._ns(e, "start")
        if "CUDA" in str(e.device_type()):
            events.append((e.name(), start, start + bench._ns(e, "duration"),
                           (e.correlation_id(), e.linked_correlation_id())))
        else:
            calls[e.correlation_id()] = (e.name(), start)
    events.sort(key=lambda e: e[1])
    if not events:
        return [], (0, 0), 0
    marker = events[0]
    offset = marker[1] - t_mark
    # a kernel's launch call shares its correlation id (else its linked one)
    matched = []
    for name, _, _, ids in events[1:]:
        c = next((c for c in ids if c and c in calls), None)
        if c is not None:
            matched.append((name, calls[c][1]))
    keep.update(launches=matched, kernels=len(events) - 1)
    return [e[:3] for e in events[1:]], (marker[2], t_end + offset), offset


def traced_run(cell, seed, seconds, trace, use_recorder, device, log):
    """``bench.run`` with the recorder (and, traced, the launch calls);
    returns its result with ``program`` added where traced."""
    from gtn_applications_tpu_torch import utils as putils

    from perfbench import bench

    recorder = putils.Recorder(device)
    state = {}
    saved = bench.instrument, bench.trace_layers, bench.profiled

    def instrument(prog, loop, spans):
        saved[0](prog, loop, spans)
        state["w0"], state["c0"] = len(recorder.spans), len(recorder.counts)

    def trace_layers(cell, prog, loop, rec, task, device):
        state["w1"], state["c1"], state["rec"] = len(recorder.spans), len(recorder.counts), rec
        return saved[1](cell, prog, loop, rec, task, device)

    def profiled(run):
        state["p0"] = len(recorder.spans)
        out = profiled_with_calls(bench, run, state)
        state["p1"], state["offset"] = len(recorder.spans), out[2]
        return out

    bench.instrument, bench.trace_layers, bench.profiled = instrument, trace_layers, profiled
    try:
        if use_recorder:
            with putils.recording(recorder):
                result = bench.run(cell, seed, seconds, trace, device, T_START, log=log)
        else:
            result = bench.run(cell, seed, seconds, trace, device, T_START, log=log)
    finally:
        bench.instrument, bench.trace_layers, bench.profiled = saved
    if trace and use_recorder and "rec" in state:
        recorder.resolve()   # the run ended at a synchronise
        rec = state["rec"]
        window = rebase(recorder.spans, state["w0"], state["w1"])
        counts = recorder.counts[state["c0"]:state["c1"]]
        profile = None
        if "p1" in state:
            profile = (rebase(recorder.spans, state["p0"], state["p1"]), rec.events,
                       rec.profile_window,
                       state["offset"], state["launches"], rec.spans[rec.window_spans:],
                       rec.profile_steps)
        metrics, extra = numbers(cell.mode, window, counts, recorder.marks, profile)
        units = {"syncs_per_step.train": "syncs"}
        result["program"] = {
            "metrics": {k: {"value": v, "unit": units.get(k, "ms")} for k, v in metrics.items()},
            "window_steps": sum(s[0] == "step" for s in window),
        }
        if extra:
            gaps, launches = extra.pop("program_idle_gaps"), extra.pop("program_launches")
            result["breakdown"]["program_idle_gaps"] = top(gaps)
            result["breakdown"]["program_launches"] = top(launches)
            extra["kernels"] = state["kernels"]
            extra.update(coverage(cell.mode, gaps, extra["idle_s"],
                                  result["breakdown"]["idle_gaps"]))
            result["program"].update(extra)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import bench

    cell = bench.Cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    from gtn_applications_tpu_torch import train as ptrain

    device = ptrain.select_device()
    result = traced_run(cell, args.seed, args.seconds, bool(args.trace), bool(args.recorder),
                        device, log=lambda text: print(text, file=sys.stderr, flush=True))
    banned = bench.banned_modules()
    if banned:
        print(f"loaded modules of {', '.join(banned)}: no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
