"""Each cell on the card, briefly, through the benchmark's command:
one JSON line with ``correct`` true. Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_bench()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
