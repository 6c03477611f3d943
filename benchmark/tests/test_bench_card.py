"""On the card: every cell of ``BENCHMARK.json`` once through ``run.py`` with a
short window, its line correct. Marked ``card``; skipped without CUDA."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=360, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
