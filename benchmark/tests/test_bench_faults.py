"""Runs with the timed path broken underneath come out not correct, at tiny
sizes on the CPU, against each cell's own limits: a step that returns its
state unchanged, half of the batch left out (the mean taken over the
rest), and an answer altered where it is produced. (No cell spans chips,
so none has an exchange between chips to leave out.) Beside them, each
cell's control: the plain reference in the precision below the one that
the configuration states, or the program's own path in it."""

from __future__ import annotations

import pytest
import torch

from benchmark import faults, harness


def run(tiny, cell, seed=3):
    root, repo = tiny
    return harness.run_cell(f"{cell}-tiny", seed, 0.1, False, device="cpu", root=root, repo=repo)


FAULTS = {cell: faults.BY_ENTRY[harness.load_cell(cell)["entry"]]
          for cell in ("td-4x6-tc", "ppo-prod-bf16", "ppo-sb3-f32", "agent-4x6-d3")}


@pytest.mark.parametrize("cell, fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_program_is_not_correct(tiny, cell, fault):
    with fault():
        result = run(tiny, cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_control_is_not_correct(tiny, cell):
    root, _ = tiny
    c = harness.load_cell(f"{cell}-tiny", root)
    entry = harness.load_entry(c, root)(c, 5, torch.device("cpu"))
    entry.control()
    checks = entry.check()
    assert any(x["value"] > x["limit"] for x in checks), checks
