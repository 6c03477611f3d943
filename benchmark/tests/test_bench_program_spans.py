"""The per-layer metrics read from the program's own spans
(``program_spans.py``): each reads a number from a recorder filled by one
tiny traced unit on the CPU, the numbers of a cell add up to the host time
of the unit its root span covers, and each reads None from an empty
recorder or from a program without one."""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
# cell: (its span metrics' suffix, the root span, the root's seconds in a metric's unit)
CELLS = {"td-4x6-tc": ("_host_us.td", "td.chunk", 1e6),
         "ppo-prod-bf16": ("_host_ms.ppo", "ppo.iteration", 1e3)}


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read_a_traced_unit(tiny, cell, monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    root, _ = tiny
    suffix, root_span, scale = CELLS[cell]
    names = [m["name"] for m in SPEC["per_layer"] if m["name"].endswith(suffix)]
    assert len(names) == {"td-4x6-tc": 6, "ppo-prod-bf16": 7}[cell]
    assert all(m["workloads"] == [cell] and m["source"] == "program_span"
               for m in SPEC["per_layer"] if m["name"] in names)
    reads = {n: harness.load_metric(n, root) for n in names}
    c = harness.load_cell(f"{cell}-tiny", root)
    entry = harness.load_entry(c, root)(c, 2 ** 31 + 5, torch.device("cpu"))
    entry.setup()
    profiler.clear()
    try:
        assert {n: read(None) for n, read in reads.items()} == dict.fromkeys(names)
        with profile(activities=[ProfilerActivity.CPU]):
            entry.unit()
        values = {n: read(None) for n, read in reads.items()}
        summary = profiler.summary()
        with monkeypatch.context() as m:  # a program with no recorder
            m.delattr(profiler, "summary")
            assert all(read(None) is None for read in reads.values())
    finally:
        profiler.clear()
    assert all(v is not None and v > 0 for v in values.values()), values
    units = summary["counters"]["td.steps"] if cell == "td-4x6-tc" else 1
    assert sum(values.values()) * units == pytest.approx(
        scale * summary["spans"][root_span]["total_s"])
