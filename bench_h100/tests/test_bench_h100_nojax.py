"""Nothing the harness loads is JAX or the JAX package: compared by the
whole top-level name of each module, since the port's name
(``rscotr_tpu_torch``) begins with the JAX package's (``rscotr_tpu``)."""

import subprocess
import sys
from pathlib import Path

from bench_h100 import harness

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import sys, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from bench_h100 import harness, run as brun, calibrate
from bench_h100.tests import _tiny
for name in _tiny.CELLS:
    ok, run, _ = brun.run_cell(_tiny.cell(name), 5, 0.3, 1, device="cpu",
                               t0=0.0)
    assert run.requests > 0
print(json.dumps(harness.forbidden_modules()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_whole_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    loaded = set(__import__("json").loads(lines[-1]))
    assert "rscotr_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rscotr_tpu_torch_probe", sys)
    assert "rscotr_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rscotr_tpu.models", sys)
    assert "rscotr_tpu" in harness.forbidden_modules()


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    runs no cell and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", "mtl_det_scene",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
