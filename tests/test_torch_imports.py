"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "gtn_applications_tpu_torch"

MODULES = [
    "gtn_applications_tpu_torch",
    "gtn_applications_tpu_torch.ops.semiring",
    "gtn_applications_tpu_torch.ops.gathers",
    "gtn_applications_tpu_torch.ops.lattice_pallas",
    "gtn_applications_tpu_torch.ops.lattice",
    "gtn_applications_tpu_torch.ops._build",
    "gtn_applications_tpu_torch.ops.viterbi_scan_pallas",
    "gtn_applications_tpu_torch.ops.dense_scan_pallas",
    "gtn_applications_tpu_torch.ops.factored",
    "gtn_applications_tpu_torch.ops.seglse_pallas",
    "gtn_applications_tpu_torch.ops.segmax_pallas",
    "gtn_applications_tpu_torch.ops.sparse_scan_pallas",
    "gtn_applications_tpu_torch.ops.sparse",
    "gtn_applications_tpu_torch.wfst",
    "gtn_applications_tpu_torch.wfst.graph",
    "gtn_applications_tpu_torch.wfst.compile",
    "gtn_applications_tpu_torch.wfst.native",
    "gtn_applications_tpu_torch.wfst.ops",
    "gtn_applications_tpu_torch.ops.convkernel",
    "gtn_applications_tpu_torch.criterions",
    "gtn_applications_tpu_torch.criterions.asg",
    "gtn_applications_tpu_torch.criterions.stc",
    "gtn_applications_tpu_torch.criterions.transducer",
    "gtn_applications_tpu_torch.models",
    "gtn_applications_tpu_torch.models.convert",
    "gtn_applications_tpu_torch.models.tds2d",
    "gtn_applications_tpu_torch.datasets",
    "gtn_applications_tpu_torch.datasets.synthetic_long",
    "gtn_applications_tpu_torch.datasets.audio",
    "gtn_applications_tpu_torch.datasets.audioset",
    "gtn_applications_tpu_torch.datasets.librispeech",
    "gtn_applications_tpu_torch.datasets.wsj",
    "gtn_applications_tpu_torch.datasets.synthetic_audio",
    "gtn_applications_tpu_torch.datasets.preprocess_librispeech",
    "gtn_applications_tpu_torch.datasets.preprocess_wsj",
    "gtn_applications_tpu_torch.criterions.ctc",
    "gtn_applications_tpu_torch.scripts.build_transitions",
    "gtn_applications_tpu_torch.scripts.wordpiece",
    "gtn_applications_tpu_torch.scripts.make_wordpieces",
    "gtn_applications_tpu_torch.scripts.fit_piece_scores",
    "gtn_applications_tpu_torch.scripts.load_arpa",
    "gtn_applications_tpu_torch.scripts.compare_ctc_viterbi",
    "gtn_applications_tpu_torch.scripts.repeat_convtrans_checks",
    "gtn_applications_tpu_torch.scripts.profile_ctc_grad",
    "gtn_applications_tpu_torch.scripts.profile_dense_bt",
    "gtn_applications_tpu_torch.scripts.profile_gather_bwd",
    "gtn_applications_tpu_torch.utils",
    "gtn_applications_tpu_torch.train",
    "gtn_applications_tpu_torch.test",
    "gtn_applications_tpu_torch.profile_step",
    "chip_smoke",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'gtn_applications_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_do_not_name_jax_package():
    pattern = re.compile(r"\bgtn_applications_tpu\.|^\s*(import|from)\s+(jax|flax)\b",
                         re.M)
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert sources
    for path in sources:
        assert not pattern.search(path.read_text()), path


def test_entry_points_need_cuda_or_flag(monkeypatch, tmp_path):
    from gtn_applications_tpu_torch import test as test_mod
    from gtn_applications_tpu_torch import train as train_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = str(tmp_path / "missing.json")
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        train_mod.main(["--config", cfg])
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        test_mod.main(["--config", cfg])
