"""The port's recorder (``utils.Recorder``).

Off, nothing is recorded.  On, spans nest with their parent and the step
index of their batch, and counters attach to the innermost open span.  One
train step, driven as ``train.train`` and the benchmark's loop drive it,
and one ``evaluate`` batch record exactly the span tree of the train and
eval paths, one ``syncs`` count a decode, and no device marks (CUDA only).
Without ``keep`` (``train.train``'s epochs) spans and counts are only
summed, and only the named marks are recorded, each step's folded once
its events have completed (on the CPU with a stand-in event; on the card,
``cuda``-marked, over 2,000 steps and in ``train.train``'s log).
``train.train`` still logs its "Timing Info" line, and with
``--profile_dir`` the exported trace holds the spans on the profiler's own
time axis.  ``profile_step``'s busy share is a union of kernel intervals.
"""

import json
import logging

import numpy as np
import pytest
import torch

from gtn_applications_tpu_torch import profile_step
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch import utils
from gtn_applications_tpu_torch.datasets import synthetic

MODEL = {
    "depth": 2,
    "tds_groups": [
        {"channels": 4, "num_blocks": 1, "stride": [2, 2]},
        {"channels": 8, "num_blocks": 1, "stride": [2, 1]},
    ],
    "kernel_size": [3, 5],
    "dropout": 0.1,
}
CPU = torch.device("cpu")


def _program(n=4):
    """A tiny TDS2d with CTC, and one batch of synthetic lines."""
    pre = synthetic.Preprocessor(None, num_features=16)
    ds = synthetic.Dataset(None, pre, split="train")
    batch = utils.padding_collate([ds[i] for i in range(n)])
    crit, n_out = utils.load_criterion("ctc", pre, {})
    model = utils.load_model("tds2d", 16, n_out, MODEL,
                             generator=torch.Generator().manual_seed(0))
    return pre, crit, model, batch


def _tree(rec):
    return [(utils.span_path(rec.spans, i), step)
            for i, (_, _, _, _, step) in enumerate(rec.spans)]


def _train_step(pre, crit, model, batch, meters):
    """One step as ``train.train`` runs it: the prepared batch, the
    device copy, the step, the decode and the meters."""
    step = train_mod.make_train_step(model, crit, 0.1, 0.1, 5.0)
    inputs, widths, targets, prepared = next(train_mod.prepared_batches([batch], crit))
    x, prepared = train_mod._to_device(inputs, prepared, CPU)
    loss, outputs = step(x, prepared, torch.Generator().manual_seed(1), 1.0)
    preds = crit.viterbi_finalize(crit.viterbi_dispatch(outputs, crit.params, None))
    meters.add_decodes(preds, targets, pre)
    return loss


def test_off_records_nothing():
    pre, crit, model, batch = _program()
    rec = utils.Recorder(CPU)
    assert utils._recorder is None
    assert utils.span("step") is utils.span("fetch")   # one shared no-op
    loss = _train_step(pre, crit, model, batch, utils.Meters())
    assert np.isfinite(float(loss))
    train_mod.evaluate(model, crit, [batch], pre, train_mod.make_eval_step(model, crit), CPU)
    assert list(utils.fetched([1, 2])) == [1, 2]
    utils.to_host(torch.ones(1))
    utils.mark("forward")
    assert (rec.spans, rec.counts, rec.marks, rec.step) == ([], [], [], 0)


def test_spans_nest_with_parent_and_step_and_counters_attach():
    rec = utils.Recorder(CPU)
    with utils.recording(rec) as installed:
        assert installed is rec and utils._recorder is rec
        for item in utils.fetched(["a", "b"]):
            with utils.span("outer"):
                rec.count("x")
                with utils.span("inner"):
                    rec.count("y", 2)
                    utils.mark("m")
                    utils.to_host(torch.ones(1))
        rec.count("z")
    assert utils._recorder is None
    assert _tree(rec) == [("fetch", 1), ("outer", 1), ("outer/inner", 1), ("outer/inner/sync", 1),
                          ("fetch", 2), ("outer", 2), ("outer/inner", 2), ("outer/inner/sync", 2),
                          ("fetch", 2)]
    assert [s[3] for s in rec.spans] == [-1, -1, 1, 2, -1, -1, 5, 6, -1]
    for name, start, end, parent, _ in rec.spans:
        assert start <= end
        if parent >= 0:
            assert rec.spans[parent][1] <= start and end <= rec.spans[parent][2]
    # a sync counts where it was called from, beside its own span
    assert rec.counts == [("x", 1, 1, 1), ("y", 2, 2, 1), ("syncs", 1, 2, 1),
                          ("x", 1, 5, 2), ("y", 2, 6, 2), ("syncs", 1, 6, 2), ("z", 1, -1, 2)]
    assert rec.marks == [] and not rec.device_marks
    assert rec.mean_ms("outer") >= 0 and rec.mean_ms("absent") is None
    # the totals sum the kept spans and counts
    outer = [e - s for n, s, e, _, _ in rec.spans if n == "outer"]
    assert rec.totals["outer"] == [sum(outer), 2]
    assert rec.mean_ms("outer") == sum(outer) / 2 / 1e6
    assert rec.counters == {"x": 2, "y": 4, "syncs": 2, "z": 1}


def test_recording_restores_the_one_before():
    a, b = utils.Recorder(), utils.Recorder()
    with utils.recording(a):
        with utils.recording(b):
            with utils.span("inner"):
                pass
        with utils.span("outer"):
            pass
    assert utils._recorder is None
    assert _tree(a) == [("outer", 0)] and _tree(b) == [("inner", 0)]


def test_one_train_step_records_the_train_tree():
    pre, crit, model, batch = _program()
    rec = utils.Recorder(CPU)
    with utils.recording(rec):
        _train_step(pre, crit, model, batch, utils.Meters())
    assert _tree(rec) == [
        ("fetch", 1), ("prepare", 1), ("to_device", 1), ("step", 1), ("step/zero_grad", 1),
        ("step/forward", 1), ("step/loss", 1), ("step/backward", 1), ("step/optimizer", 1),
        ("sync", 1), ("meters", 1)]
    assert rec.counts == [("syncs", 1, -1, 1)]
    assert rec.marks == []   # device marks are CUDA events


def test_one_eval_batch_records_the_eval_tree():
    pre, crit, model, batch = _program()
    rec = utils.Recorder(CPU)
    with utils.recording(rec):
        meters = train_mod.evaluate(model, crit, [batch], pre,
                                    train_mod.make_eval_step(model, crit), CPU)
    assert meters.num_samples == 4
    assert _tree(rec) == [
        ("fetch", 1), ("prepare", 1), ("to_device", 1), ("step", 1), ("step/forward", 1),
        ("step/loss", 1), ("decode", 1), ("decode/sync", 1), ("meters", 1),
        ("fetch", 1), ("sync", 1)]
    decode = [i for i, s in enumerate(rec.spans) if s[0] == "decode"]
    # one count a decode, and the pass's final loss read
    assert rec.counts == [("syncs", 1, decode[0], 1), ("syncs", 1, -1, 1)]
    assert rec.marks == []


def test_without_keep_spans_and_counts_are_only_summed():
    rec = utils.Recorder(CPU, keep=False)
    with utils.recording(rec):
        for item in utils.fetched(["a", "b"]):
            with utils.span("outer"):
                rec.count("x")
                with utils.span("inner"):
                    utils.to_host(torch.ones(1))
    assert (rec.spans, rec.counts, rec.marks, rec._open) == ([], [], [], [])
    assert {k: n for k, (_, n) in rec.totals.items()} == {
        "fetch": 3, "outer": 2, "inner": 2, "sync": 2}
    assert rec.counters == {"x": 2, "syncs": 2}
    assert rec.mean_ms("outer") >= rec.mean_ms("inner") >= rec.mean_ms("sync") >= 0


class _Event:
    """``torch.cuda.Event`` on the CPU: records the ms in ``clock`` and
    has completed unless told otherwise."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t, self.done = None, True

    def record(self):
        self.t = _Event.clock

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t - self.t


def test_kept_marks_resolve_to_ms_and_every_interval(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    rec = utils.Recorder("cuda")
    with utils.recording(rec):
        for k in utils.fetched(range(2)):
            for name, ms in (("a", 0.0), ("b", 1.0), ("c", 3.0)):
                _Event.clock = 10.0 * k + ms
                utils.mark(name)
    assert all(isinstance(m[2], _Event) for m in rec.marks)   # not read before resolve
    rec.resolve()
    assert rec.marks == [["a", 1, 0.0], ["b", 1, 1.0], ["c", 1, 3.0],
                         ["a", 2, 10.0], ["b", 2, 11.0], ["c", 2, 13.0]]
    intervals = {("a", "b"): [2.0, 2], ("a", "c"): [6.0, 2], ("b", "c"): [4.0, 2]}
    assert rec.intervals == intervals
    assert rec.resolve().intervals == intervals   # folded once
    assert rec.mark_ms("a", "c") == 3.0 and rec.mark_ms("c", "a") is None


def test_without_keep_only_named_marks_stay_and_only_until_their_step_completes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    rec = utils.Recorder("cuda", marks=train_mod.STEP_MARKS, keep=False)
    t = torch.ones(2, requires_grad=True)
    held = []
    with utils.recording(rec):
        for k in utils.fetched(range(1, 6)):
            held.append(len(rec.marks))
            if k == 4:
                rec.marks[1][2].done = True   # step 3's last event completes
            _Event.clock = 100.0 * k
            utils.mark("forward")
            utils.mark("forward.end")            # not named: no event
            utils.mark_grad(t, "outputs.grad")   # not named: no hook
            _Event.clock += k
            utils.mark("optimizer.end")
            if k == 3:
                rec.marks[-1][2].done = False    # still running on the device
    # the next batch folded each completed step; step 3 waited a step
    assert held == [0, 0, 0, 2, 0]
    assert not t._backward_hooks
    assert [m[:2] for m in rec.marks] == [["forward", 5], ["optimizer.end", 5]]
    rec.resolve()
    assert rec.marks == [] and rec.spans == []
    assert rec.intervals == {("forward", "optimizer.end"): [15.0, 5]}
    assert rec.mark_ms(*train_mod.STEP_MARKS) == 3.0


@pytest.mark.cuda
def test_without_keep_marks_on_the_card_stay_bounded_over_many_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device marks are CUDA events")
    x = torch.randn(256, 256, device="cuda")
    rec = utils.Recorder("cuda", marks=("a", "b"), keep=False)
    held = []
    with utils.recording(rec):
        for _ in utils.fetched(range(2000)):
            held.append(len(rec.marks))
            utils.mark("a")
            y = x @ x
            utils.mark("b")
            utils.to_host(y[0, :1])
    rec.resolve()
    assert max(held) <= 2 and rec.marks == []
    assert rec.intervals[("a", "b")][1] == 2000 and rec.mark_ms("a", "b") > 0
    assert rec.counters == {"syncs": 2000} and rec.totals["fetch"][1] == 2001


def _config(tmp_path):
    config = {
        "seed": 0,
        "data": {"dataset": "synthetic", "num_features": 16},
        "model_type": "tds2d",
        "model": MODEL,
        "criterion_type": "ctc",
        "optim": {"batch_size": 16, "epochs": 1, "learning_rate": 0.02,
                  "step_size": 40, "max_grad_norm": 5},
    }
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    return str(cfg)


def test_train_logs_its_timing_info(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    train_mod.train(train_mod.parse_args(
        ["--config", _config(tmp_path), "--checkpoint_path", str(tmp_path),
         "--disable_cuda"]))
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Timing Info: ")]
    assert len(lines) == 1
    fields = dict(f.split(" : ") for f in lines[0][len("Timing Info: "):].split(", "))
    assert list(fields) == ["fetch", "prepare", "to_device", "enqueue", "sync", "meters",
                            "train_total", "test_total"]
    assert all(v.endswith("ms") and float(v[:-2]) >= 0 for v in fields.values())


@pytest.mark.cuda
def test_train_on_the_card_logs_the_step_device_time(tmp_path, caplog):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device marks are CUDA events")
    caplog.set_level(logging.INFO)
    train_mod.train(train_mod.parse_args(
        ["--config", _config(tmp_path), "--checkpoint_path", str(tmp_path)]))
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Timing Info: ")]
    fields = dict(f.split(" : ") for f in lines[0][len("Timing Info: "):].split(", "))
    assert list(fields) == ["fetch", "prepare", "to_device", "enqueue", "sync", "meters",
                            "step_device", "train_total", "test_total"]
    assert 0 < float(fields["step_device"][:-2]) < float(fields["train_total"][:-2])


def test_profile_dir_trace_holds_the_spans_on_its_clock(tmp_path):
    train_mod.train(train_mod.parse_args(
        ["--config", _config(tmp_path), "--checkpoint_path", str(tmp_path),
         "--disable_cuda", "--profile_dir", str(tmp_path / "prof")]))
    events = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program"]
    steps = [e for e in spans if e["name"] == "step"]
    assert len(steps) == 64 // 16
    assert {e["args"]["path"] for e in spans} >= {
        "train_epoch/fetch", "train_epoch/step/forward", "train_epoch/step/optimizer",
        "train_epoch/sync", "train_epoch/meters"}
    # the profiler's own convolutions of the forward fall in the forward
    # spans (on the thread that steps: the loader's thread builds lines)
    forwards = [(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == "forward"]
    tid = next(e["tid"] for e in events if e.get("name") == train_mod.TRACE_CLOCK)
    convs = [e for e in events if e.get("name") == "aten::conv2d" and e.get("ph") == "X"
             and e.get("tid") == tid]
    assert convs
    slack = 50.0   # us: the clock annotation's own width
    for c in convs:
        assert any(s - slack <= c["ts"] and c["ts"] + c["dur"] <= e + slack
                   for s, e in forwards), c


def test_busy_share_is_the_union_of_kernel_intervals():
    # two overlapping kernels and one apart: 30 + 10 us busy, not 50
    assert profile_step.union_us([(0, 20), (10, 30), (50, 60)]) == 40
    assert profile_step.union_us([(5, 6), (0, 10)]) == 10
    assert profile_step.union_us([]) == 0


@pytest.mark.parametrize("name", ["span", "mark", "to_host", "fetched"])
def test_each_entry_point_is_inert_without_a_recorder(name):
    rec = utils.Recorder(CPU)
    if name == "span":
        with utils.span("x") as i:
            assert i is None
    elif name == "mark":
        t = torch.ones(2, requires_grad=True)
        utils.mark("forward")
        utils.mark_grad(t, "outputs.grad")
        assert not t._backward_hooks
    elif name == "to_host":
        assert torch.equal(utils.to_host(torch.arange(3)), torch.arange(3))
    else:
        assert list(utils.fetched(iter(range(3)))) == [0, 1, 2]
    assert (rec.spans, rec.counts, rec.marks) == ([], [], [])
    assert utils._recorder is None
