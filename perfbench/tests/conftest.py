import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# a corpus and batch that a CPU test run holds, at the recipes' widths
TINY = {"traffic": {"lines": 12, "profile_steps": 2,
                    "text": {"length_mean": 9, "length_sd": 2, "length_min": 6,
                             "length_max": 12}},
        "config": {"optim": {"batch_size": 4}}}


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gtn_applications_tpu_torch import train as ptrain

    return ptrain.select_device()


@pytest.fixture(autouse=True)
def _few_threads():
    """One intra-op thread a test process: the suite runs several
    processes at once, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
