"""The readers of the TD step tail's span and counter (``tail_host_self_us.td``,
``tail_replay_share.td``): nothing without the span or the counter, from an
empty recorder or from a program without one, and the arithmetic on a
summary."""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAMES = ("tail_host_self_us.td", "tail_replay_share.td")


def summary_of(spans: dict, counters: dict) -> dict:
    return {"spans": {k: {"calls": c, "total_s": s, "self_s": s} for k, (c, s) in spans.items()},
            "counters": counters}


def test_listed_for_the_td_cell_in_the_step_layer():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NAMES:
        m = by_name[name]
        assert m["workloads"] == ["td-4x6-tc"] and m["moves"] == "td_steps_per_s"
        assert m["layer"] == "TD step (train/td.py)"
    assert by_name["tail_host_self_us.td"]["source"] == "program_span"
    assert by_name["tail_replay_share.td"]["source"] == "program_counter"


@pytest.mark.parametrize("summary, host_us, share", [
    (summary_of({"td.tail": (128, 0.0064)}, {"td.steps": 128, "td.tail_replays": 128}),
     50.0, 100.0),
    (summary_of({"td.tail": (64, 0.0032)}, {"td.steps": 128, "td.tail_replays": 64}),
     25.0, 50.0),
    # the parent's window: the step's spans, no tail and no replay
    (summary_of({"td.chunk": (2, 0.1), "td.restart": (128, 0.3)}, {"td.steps": 128}),
     None, None),
    (summary_of({"td.tail": (4, 0.001)}, {"td.steps": 4}), 250.0, None),  # off the card
    (summary_of({"td.tail": (4, 0.001)}, {"td.tail_replays": 4}), None, None),  # no steps
    ({"spans": {}, "counters": {}}, None, None),
])
def test_arithmetic_on_a_summary(summary, host_us, share, monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "summary", lambda: summary)
    host, rate = (harness.load_metric(n)(None) for n in NAMES)
    assert host == (pytest.approx(host_us) if host_us is not None else None)
    assert rate == (pytest.approx(share) if share is not None else None)


def test_none_from_an_empty_recorder_or_a_program_without_one(monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    reads = [harness.load_metric(n) for n in NAMES]
    profiler.clear()
    try:
        assert [read(None) for read in reads] == [None, None]
        with profile(activities=[ProfilerActivity.CPU]):
            torch.ones(4).sum()
        assert [read(None) for read in reads] == [None, None]
        monkeypatch.delattr(profiler, "summary")
        assert [read(None) for read in reads] == [None, None]
    finally:
        profiler.clear()
