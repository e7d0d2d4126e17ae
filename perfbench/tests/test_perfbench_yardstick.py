import pytest

from perfbench import bench, yardstick
from perfbench.reference import tds2d_lattice


def test_tds2d_flops_by_hand():
    cfg = {"depth": 2, "kernel_size": [3, 5],
           "tds_groups": [{"channels": 2, "num_blocks": 1, "stride": [2, 2]}]}
    # conv 1 -> 4 channels, out H 4, W ceil(9 / 2) = 5: 2*1*4*15*20 = 2,400
    # block: conv 2 -> 2 over D=2 planes 2*2*2*15*2*20 = 4,800; two dense
    # 4 -> 4 layers 2*2*4*4*20 = 1,280; head (4*4 -> 3) 2*16*3*5 = 480
    assert tds2d_lattice.forward_flops(cfg, 8, 3, 9) == 2400 + 4800 + 1280 + 480


def test_recipe_flops_a_column():
    """The CTC recipe's task counts ~11.4 MFLOP a pixel column forward."""
    cell = bench.Cell("iam_tds2d_ctc.train")
    task = cell.reference.Task(cell.cfg, [chr(97 + i) for i in range(78)], cell.root)
    assert task.output_size == 79
    per_col = task.forward_flops(4096) / 4096
    assert 11.0e6 < per_col < 11.8e6


def test_criterion_least_time():
    t, bound = yardstick.criterion_least_seconds(2, 10, 5, 0, 0)
    assert bound == "bytes" and t == pytest.approx(2 * 4 * 100 / 3.35e12)
    t, bound = yardstick.criterion_least_seconds(1, 1000, 1, 10**6, 10**6)
    assert bound == "operations"
    assert t == pytest.approx(3 * 1000 * 5 * 10**6 / 67e12)


def test_union_not_sum():
    events = [(0, 10), (5, 15), (20, 30), (22, 25)]
    assert yardstick.union_seconds(events) == pytest.approx(25e-9)
    assert yardstick.idle_gaps(events, 0, 40) == [(15, 20), (30, 40)]
    assert yardstick.idle_gaps([], 3, 7) == [(3, 7)]
