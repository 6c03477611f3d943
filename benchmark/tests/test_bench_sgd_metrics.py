"""The readers of the PPO SGD step's span and counters
(``sgd_host_self_ms.ppo``, ``sgd_replay_share.ppo``): nothing without the
span or the counters, from an empty recorder, from a program without one or
from a CPU iteration (no step replays there), and the arithmetic on a
summary."""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAMES = ("sgd_host_self_ms.ppo", "sgd_replay_share.ppo")


def summary_of(spans: dict, counters: dict) -> dict:
    return {"spans": {k: {"calls": c, "total_s": s, "self_s": s} for k, (c, s) in spans.items()},
            "counters": counters}


def test_listed_for_the_ppo_cell_in_the_update_layer():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NAMES:
        m = by_name[name]
        assert m["workloads"] == ["ppo-prod-bf16"] and m["moves"] == "ppo_steps_per_s"
        assert m["layer"] == "update, model (train/ppo.py)"
    assert by_name["sgd_host_self_ms.ppo"]["source"] == "program_span"
    assert by_name["sgd_replay_share.ppo"]["source"] == "program_counter"


@pytest.mark.parametrize("summary, host_ms, share", [
    (summary_of({"ppo.iteration": (1, 2.0), "ppo.sgd": (128, 0.128)},
                {"ppo.sgd_steps": 128, "ppo.sgd_replays": 128}), 128.0, 100.0),
    (summary_of({"ppo.iteration": (2, 4.0), "ppo.sgd": (252, 0.3)},
                {"ppo.sgd_steps": 256, "ppo.sgd_replays": 252}), 150.0, 98.4375),
    # the parent's window: the eager step's spans, no replay
    (summary_of({"ppo.iteration": (1, 2.0), "ppo.forward": (128, 0.9)},
                {"ppo.sgd_steps": 128}), None, None),
    (summary_of({"ppo.iteration": (1, 2.0)}, {}), None, None),
    # off the card: the buffered step's span, no replay
    (summary_of({"ppo.iteration": (1, 2.0), "ppo.sgd": (6, 0.003)},
                {"ppo.sgd_steps": 8}), 3.0, None),
    (summary_of({"ppo.sgd": (4, 0.001)}, {"ppo.sgd_replays": 4}), None, None),  # no unit
    ({"spans": {}, "counters": {}}, None, None),
])
def test_arithmetic_on_a_summary(summary, host_ms, share, monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "summary", lambda: summary)
    host, rate = (harness.load_metric(n)(None) for n in NAMES)
    assert host == (pytest.approx(host_ms) if host_ms is not None else None)
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


def test_a_cpu_iteration_counts_its_steps_and_no_replay():
    """A traced PPO iteration on the CPU, eager as its default: the steps
    are counted, no step replays, so both readers give None."""
    from gym2048_tpu_torch.train import ppo
    from gym2048_tpu_torch.utils import profiler

    tr = ppo.PPO(ppo.PPOConfig(n_envs=8, n_steps=4, batch_size=16, n_epochs=2, filters=4,
                               residual_blocks=1), device="cpu")
    state = tr.init_state()
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tr.train_iteration(state)
        assert profiler.summary()["counters"] == {"ppo.sgd_steps": 4}
        assert [harness.load_metric(n)(None) for n in NAMES] == [None, None]
    finally:
        profiler.clear()
