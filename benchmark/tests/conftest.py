"""Shared fixtures of the benchmark's tests: tiny cells on the CPU.

A tiny cell is a real cell of ``workloads/`` with its traffic (and, where
needed, its configuration) cut to a size the CPU runs in seconds. The
fixtures write it into a copy of the benchmark's data under a temporary
root, beside the real entries and metrics, so the harness finds it by name
as it finds every cell.

Tests that need a card carry the ``card`` marker; the card is looked for
inside the test, never while this file is imported.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the traffic (and configuration) cuts of each real cell for the CPU
TINY = {
    "td-4x6-tc": ({"n_envs": 32, "chunk_steps": 16, "tc_every": 4, "carousel_slots": 8},
                  {"n_vals": 4, "thresholds": [3, 4]}),
    "agent-4x6-d3": ({"games": 8, "k_deep": 2, "chunk_moves": 16, "check_moves": 64,
                      "trace_moves": 16, "move_cap": 64}, {"n_vals": 6, "thresholds": [3, 4]}),
    "ppo-prod-bf16": ({"n_envs": 8, "n_steps": 8, "batch_size": 16, "n_epochs": 2},
                      {"filters": 8, "residual_blocks": 1}),
    "ppo-sb3-f32": ({"n_envs": 4, "n_steps": 8, "batch_size": 8, "n_epochs": 2},
                    {"filters": 8, "residual_blocks": 1}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def make_tiny_root(tmp: Path, limits: dict | None = None) -> tuple[Path, Path]:
    """A benchmark root and a repository root under ``tmp`` holding the tiny
    cells ``<cell>-tiny`` and a ``BENCHMARK.json`` that lists them beside the
    real one's metrics. Returns ``(root, repo)``."""
    root = tmp / "bench"
    for d in ("entries", "metrics", "configs", "workloads"):
        shutil.copytree(BENCH / d, root / d)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    tiny_cells = []
    for cell, (traffic, config) in TINY.items():
        w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        c = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
        c.update(config)
        w["config"] = f"{w['config']}-tiny-{cell}"
        (root / "configs" / f"{w['config']}.json").write_text(json.dumps(c))
        w["traffic"].update(traffic)
        if limits:
            w["limits"].update(limits.get(cell, {}))
        (root / "workloads" / f"{cell}-tiny.json").write_text(json.dumps(w))
        tiny_cells.append(cell)
    for m in spec["per_layer"]:
        m["workloads"] = m.get("workloads", []) + [f"{c}-tiny" for c in m.get("workloads", [])]
    repo = tmp / "repo"
    repo.mkdir()
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, repo


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
