"""The reader of the delayed-TC combine's counter (``sparse_combine_share.td``): nothing
without the counter, from an empty recorder or from a program without one, and the arithmetic
on a summary."""

from __future__ import annotations

import json
import types

import pytest

from benchmark import harness
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = "sparse_combine_share.td"
CTX = types.SimpleNamespace(entry=types.SimpleNamespace(traffic={"tc_every": 8}))


def test_listed_for_the_td_cell_in_the_table_update_layer():
    m = {m["name"]: m for m in SPEC["per_layer"]}[NAME]
    assert m["workloads"] == ["td-4x6-tc"] and m["moves"] == "td_steps_per_s"
    assert m["layer"] == "table update (models/ntuple.py::_tc_combine)"
    assert m["source"] == "program_counter" and m["unit"] == "%"


@pytest.mark.parametrize("counters, share", [
    ({"td.steps": 128, "td.sparse_combines": 16}, 100.0),
    ({"td.steps": 128, "td.sparse_combines": 8}, 50.0),
    ({"td.steps": 128}, None),  # the dense combine of every entry: no counter
    ({"td.sparse_combines": 16}, None),  # no steps
])
def test_arithmetic_on_a_summary(counters, share, monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "summary", lambda: {"spans": {}, "counters": counters})
    got = harness.load_metric(NAME)(CTX)
    assert got == (pytest.approx(share) if share is not None else None)


def test_none_from_an_empty_recorder_or_a_program_without_one(monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    read = harness.load_metric(NAME)
    profiler.clear()
    assert read(CTX) is None
    monkeypatch.delattr(profiler, "summary")
    assert read(CTX) is None
