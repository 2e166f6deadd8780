"""On the card: the benchmark's command runs each cell once with a short
window and prints a correct result line with the cell's metrics."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if w["chips"] == 1])
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "2", "--trace", str(trace)],
        cwd=run.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    names = {m["name"] for m in run.cell_metrics(BENCH, cell, bool(trace))}
    assert set(line["metrics"]) <= names and line["metrics"]
    assert list(line)[-1] == "checks"
