import subprocess
import sys

from conftest import ROOT

from perfbench import bench


def test_top_level_names_compared_whole():
    names = ["gtn_applications_tpu_torch", "gtn_applications_tpu_torch.ops",
             "jaxlib.xla_client", "gtn_applications_tpu.models", "flaxen", "jax_like",
             "perfbench.bench"]
    assert bench.banned_modules(names) == ["gtn_applications_tpu", "jaxlib"]
    assert bench.banned_modules(["jax"]) == ["jax"]


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no module of JAX or of
    the JAX package loaded."""
    code = (
        "import sys, torch; torch.set_num_threads(1); sys.path.insert(0, 'perfbench/tests'); sys.path.insert(0, '.');"
        "from conftest import TINY; from perfbench import bench;"
        "cell = bench.Cell('iam_tds2d_wdecomp.train', overrides=TINY);"
        "bench.run(cell, 1, 0.2, False, torch.device('cpu'), log=None);"
        "print('BANNED', bench.banned_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "BANNED []"


def test_no_result_without_a_card(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "iam_tds2d_ctc.train",
         "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_every_named_file_exists():
    import json

    spec = bench.Cell("iam_tds2d_ctc.train").spec
    parked = json.loads((ROOT / "perfbench/parked.json").read_text())
    assert not {w["name"] for w in spec["workloads"]} & {w["name"] for w in parked["workloads"]}
    for w in spec["workloads"] + parked["workloads"]:
        cell = bench.Cell(w["name"])
        assert (ROOT / "perfbench/limits" / f"{w['name']}.json").exists()
        for m in cell.metrics(False) + cell.metrics(True):
            assert callable(cell.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    """The entries' keys, names and cross-references as the harness and
    the check read them."""
    import json
    import re

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    configs = {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
    assert configs == {w["config"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        # every cell it lists reports the end-to-end metric it moves
        reported = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(reported), m["name"]
    for n in [*configs, *cells, *e2e, *(m["name"] for m in spec["per_layer"])]:
        assert name.match(n), n
    for cell in cells:
        reports = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert any(cell in m["workloads"] for m in spec["per_layer"])
