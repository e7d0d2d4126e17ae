"""Each cell's loop run on the CPU at a tiny size against the plain
reference, sound and with the timed path broken underneath."""

import json
import math

import numpy as np
import pytest
import torch
from conftest import TINY

from perfbench import bench, faults
from perfbench import traffic as traffic_mod

CELLS = ["iam_tds2d_ctc.train", "iam_tds2d_wdecomp.train", "iam_tds2d_ctc.eval",
         "iam_tds2d_wdecomp.eval"]
FAULTS = [(c, f) for c in CELLS for f in ("half_batch", "altered_token")
          ] + [(c, "unchanged_state") for c in CELLS if c.endswith(".train")]


def _run(name, seed, trace=False):
    cell = bench.Cell(name, overrides=TINY)
    return bench.run(cell, seed, 0.5, trace, torch.device("cpu"), log=None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(name):
    res = _run(name, 2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {m["name"] for m in bench.Cell(name).metrics(False)}
    # the step periods come from CUDA events, which a CPU run has not
    assert set(res["metrics"]) == e2e - {"train_step_ms_p95"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_fails(name, fault):
    with faults.FAULTS[fault]():
        res = _run(name, 17)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["iam_tds2d_ctc.train", "iam_tds2d_ctc.eval"])
def test_result_line_schema(name):
    res = _run(name, 5)
    line = json.loads(json.dumps(res))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


def test_reference_matches_the_port_criteria():
    """The reference's lattice scores the port's CTC and word
    decompositions alike on random logits."""
    from gtn_applications_tpu_torch.criterions import CTC, Transducer
    from gtn_applications_tpu_torch.datasets.text import TextPreprocessor

    for name in ("iam_tds2d_ctc.train", "iam_tds2d_wdecomp.train"):
        cell = bench.Cell(name)
        corpus = traffic_mod.make_corpus(dict(cell.traffic, lines=4), 9, cell.root)
        task = cell.reference.Task(cell.cfg, corpus.chars, cell.root)
        targets = [task.target(t[:14]) for t in corpus.texts]
        logits = torch.randn(4, 24, task.output_size, generator=torch.Generator().manual_seed(1))
        if name.startswith("iam_tds2d_ctc"):
            crit = CTC(task.blank)
        else:
            pre = TextPreprocessor(["".join(corpus.chars)],
                                   tokens_path=str(cell.root / cell.cfg["tokens_file"]))
            crit = Transducer(pre.tokens, pre.graphemes_to_index, blank="optional",
                              allow_repeats=False, reduction="mean")
        port = crit.loss({}, logits, crit.prepare([np.asarray(t) for t in targets]))
        ref = cell.reference.loss(logits.double(), targets, task.pieces, task.blank)
        assert float(port) == pytest.approx(float(ref), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, cuda_device):
    """The reference in TF32, in the program's place, fails the check."""
    cell = bench.Cell(name, overrides={"traffic": {"lines": 64}})
    corpus = traffic_mod.make_corpus(cell.traffic, 23, cell.root)
    task = cell.reference.Task(cell.cfg, corpus.chars, cell.root)
    prog = bench.Program(cell, corpus, task, 23, cuda_device)
    if cell.mode == "train":
        raw = bench.first_steps(bench.TrainLoop(prog), prog)
    else:
        _, batches = bench.EvalLoop(prog).epoch()
        raw = {"w0": prog.w0, "batches": [(c, float(l), d) for c, l, d in batches]}
    ref = bench.reference(cell, task, corpus, raw, cuda_device)
    control = bench.as_program(cell, task, bench.reference(cell, task, corpus, raw, cuda_device,
                                                           tf32=True))
    nums = bench.numbers(cell, task, control, ref)
    assert any(nums[k] > lim for k, lim in cell.limits.items()), nums
