"""The reader of the PPO rollout step's counters (``rollout_replay_share.ppo``):
nothing without the counters, from an empty recorder, from a program without
one or from a CPU rollout (no step replays there), and the arithmetic on a
summary."""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = "rollout_replay_share.ppo"


def summary_of(counters: dict) -> dict:
    return {"spans": {"ppo.iteration": {"calls": 1, "total_s": 1.0, "self_s": 0.1}},
            "counters": counters}


def test_listed_for_the_ppo_cell_in_the_rollout_layer():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    m = by_name[NAME]
    assert m["workloads"] == ["ppo-prod-bf16"] and m["moves"] == "ppo_steps_per_s"
    assert m["layer"] == by_name["env_host_ms.ppo"]["layer"]
    assert m["source"] == "program_counter" and m["unit"] == "%"


@pytest.mark.parametrize("counters, share", [
    ({"ppo.rollout_steps": 128, "ppo.rollout_replays": 128}, 100.0),
    ({"ppo.rollout_steps": 256, "ppo.rollout_replays": 254}, 99.21875),
    # the parent's window: the eager rollout counts nothing
    ({"ppo.sgd_steps": 128}, None),
    # a holder's warm-up steps on the card alone: counted, none a replay
    ({"ppo.rollout_steps": 8}, None),
    ({"ppo.rollout_replays": 4}, None),
    ({}, None),
])
def test_arithmetic_on_a_summary(counters, share, monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "summary", lambda: summary_of(counters))
    got = harness.load_metric(NAME)(None)
    assert got == (pytest.approx(share) if share is not None else None)


def test_none_from_an_empty_recorder_or_a_program_without_one(monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    read = harness.load_metric(NAME)
    profiler.clear()
    try:
        assert read(None) is None
        with profile(activities=[ProfilerActivity.CPU]):
            torch.ones(4).sum()
        assert read(None) is None
        monkeypatch.delattr(profiler, "summary")
        assert read(None) is None
    finally:
        profiler.clear()


@pytest.mark.parametrize("n_rollouts", [1, 2])
def test_a_cpu_rollout_replays_no_step(n_rollouts):
    """Traced PPO rollouts on the CPU, through the holder's warm-ups and
    past them: no step replays and none is counted, so the reader gives
    None."""
    from gym2048_tpu_torch.train import ppo
    from gym2048_tpu_torch.utils import profiler

    tr = ppo.PPO(ppo.PPOConfig(n_envs=8, n_steps=4, batch_size=16, n_epochs=2, filters=4,
                               residual_blocks=1), device="cpu")
    state = tr.init_state()
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n_rollouts):
                tr._collect_rollout(state)
        assert profiler.summary()["counters"] == {}
        assert harness.load_metric(NAME)(None) is None
    finally:
        profiler.clear()
