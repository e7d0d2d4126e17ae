"""``program_trace``'s reductions on synthetic spans, events and marks,
and a tiny CPU run of each cell with the port's recorder installed."""

import pytest
import torch
from conftest import TINY

from perfbench import bench
from perfbench import program_trace as pt

# two steps of a train loop, in ns: fetch, step (forward, backward), meters
SPANS = [
    ["fetch", 0, 10, -1, 1], ["step", 10, 100, -1, 1], ["forward", 12, 50, 1, 1],
    ["backward", 50, 98, 1, 1], ["meters", 100, 120, -1, 1],
    ["fetch", 120, 130, -1, 2], ["step", 130, 220, -1, 2], ["forward", 132, 170, 6, 2],
    ["backward", 170, 218, 6, 2], ["meters", 220, 240, -1, 2],
]


def test_innermost_walks_up_to_the_span_that_holds_the_time():
    find = pt.innermost(SPANS)
    assert [find(t) for t in (5, 11, 20, 60, 99, 110, 131, 250, -1)] == \
        [0, 1, 2, 3, 1, 4, 6, -1, -1]
    # on the profiler's clock: shifted by the offset
    assert pt.innermost(SPANS, 1000)(1020) == 2
    assert pt.path(SPANS, 3) == "step/backward" and pt.path(SPANS, -1) == pt.OUTSIDE


def test_rebase_counts_parents_from_the_slice():
    assert [s[3] for s in pt.rebase(SPANS, 5, 10)] == [-1, -1, 1, 1, -1]
    assert [s[3] for s in pt.rebase(SPANS, 2, 4)] == [-1, -1]


def test_idle_and_launches_by_the_innermost_span():
    gaps = [(96, 104), (110, 130), (240, 260)]   # middles 100, 120, 250
    idle = pt.idle_by_span(gaps, SPANS, 0)
    assert idle == {"meters": 8e-9, "fetch": 20e-9, pt.OUTSIDE: 20e-9}
    launches = [("k1", 13), ("k2", 60), ("Memcpy HtoD", 61), ("k3", 171), ("k4", 300)]
    assert pt.launches_by_span(launches, SPANS, 0, 2) == {
        "step/forward": 0.5, "step/backward": 1.0, pt.OUTSIDE: 0.5}


def test_shares_and_overlaps():
    assert pt.inside_share([5, 15, 25, 35], [(0, 20), (30, 40)], [(10, 40)]) == 2 / 3
    assert pt.inside_share([50], [(0, 20)], [(0, 20)]) is None
    assert pt.overlap_seconds([(0, 10), (20, 30)], [(5, 25)]) == 10e-9


def test_step_marks_split_encoder_criterion_and_optimizer():
    marks = [["forward", 1, 0.0], ["forward.end", 1, 10.0],
             ["outputs.grad", 1, 11.0], ["backward.end", 1, 30.0],
             ["optimizer.end", 1, 34.0],
             ["forward", 2, 40.0], ["forward.end", 2, 50.0]]   # step 2 lacks marks
    assert pt.step_marks_ms(marks, {1, 2}) == [(29.0, 1.0, 4.0)]
    assert pt.step_marks_ms(marks, {2}) == []


def test_numbers_of_a_window_and_a_profile():
    counts = [("syncs", 1, -1, 1), ("syncs", 1, -1, 2), ("other", 5, -1, 2)]
    marks = [[n, k, ms + 100.0 * k] for k in (1, 2) for n, ms in (
        ("forward", 0.0), ("forward.end", 10.0), ("outputs.grad", 11.0),
        ("backward.end", 30.0), ("optimizer.end", 34.0))]
    events = [("k", 12, 40), ("k", 60, 98), ("k", 132, 200)]
    harness = [("step", 9, 101), ("step", 129, 221)]
    launches = [("k", 12), ("k", 55), ("k", 131)]
    profile = (SPANS, events, (0, 240), 0, launches, harness, 2)
    out, extra = pt.numbers("train", SPANS, counts, marks, profile)
    assert out["syncs_per_step.train"] == 1.0
    assert out["meters_ms.train"] == pytest.approx(20e-6)
    assert (out["step_encoder_ms.train"], out["step_criterion_ms.train"],
            out["step_optimizer_ms.train"]) == (29.0, 1.0, 4.0)
    # idle inside the steps: 10-12, 40-60, 98-100, 130-132, 200-220 = 46 ns
    assert out["step_idle_ms.train"] == pytest.approx(1e3 * 46e-9 / 2)
    assert extra["clock_share"] == 1.0 and extra["launch_calls"] == 3
    assert extra["profiled_marks_ms"] == {"encoder": 29.0, "criterion": 1.0, "optimizer": 4.0}
    cover = pt.coverage("train", extra["program_idle_gaps"], extra["idle_s"],
                        [["step", 44e-9], ["fetch", 1e-9]])
    assert cover["step_children_share"] == pytest.approx(
        sum(v for k, v in extra["program_idle_gaps"].items() if k.startswith("step/")) / 44e-9)
    ev, _ = pt.numbers("eval", SPANS, counts, [], None)
    assert set(ev) == {"sync_wait_ms.eval", "meters_ms.eval"}
    assert pt.coverage("eval", {pt.OUTSIDE: 1.0, "meters": 3.0}, 4.0, [])["outside_share"] == 0.25


@pytest.mark.parametrize("workload", ["iam_tds2d_ctc.train", "iam_tds2d_ctc.eval"])
def test_a_tiny_cpu_run_reads_the_recorder(workload):
    """On the CPU the run has no profile and no marks: the host spans and
    the sync count alone, one sync a decode."""
    cell = bench.Cell(workload, overrides=TINY)
    result = pt.traced_run(cell, 2**31 + 11, 0.3, True, True, torch.device("cpu"), None)
    metrics = result["program"]["metrics"]
    assert result["program"]["window_steps"] > 0
    if cell.mode == "train":
        assert metrics["syncs_per_step.train"]["value"] == 1.0
        assert set(metrics) == {"syncs_per_step.train", "meters_ms.train"}
    else:
        assert set(metrics) == {"sync_wait_ms.eval", "meters_ms.eval"}
    assert all(m["value"] >= 0 for m in metrics.values())
    assert bench.instrument.__module__ == "perfbench.bench"   # restored
