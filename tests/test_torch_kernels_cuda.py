"""The port's CUDA kernel wrappers refuse what their kernels do not take.

These tests need an NVIDIA GPU; elsewhere they skip.  Each kernel is held
against its plain version on the card by ``chip_smoke.py`` (phases 3-5),
at the bench headline and at the main path's shapes.  The file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest \
        -o addopts="" -m cuda -q
"""

import pytest
import torch

from gtn_applications_tpu_torch.ops import gathers, lattice_pallas


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(2, 3, 4, device=cuda_device)
    idx = torch.zeros(2, 5, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        gathers.gather_fwd_cuda(x.double(), idx)
    with pytest.raises(ValueError):
        gathers.gather_fwd_cuda(x, idx.cpu())
    with pytest.raises(ValueError):
        gathers.gather_bwd_cuda(torch.zeros(2, 3, 6, device=cuda_device), idx, 4)
    em = torch.zeros(2, 3, 5, device=cuda_device)
    with pytest.raises(ValueError):
        lattice_pallas.ctc_alpha_cuda(
            em, em[:, 0], em[:, 0], torch.zeros(2, dtype=torch.int64,
                                                 device=cuda_device))
