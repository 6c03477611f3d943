"""Every cell, cut to a tiny size, run end to end on the CPU: the result
line's shape, and the program against the plain reference."""

from __future__ import annotations

import json

import pytest

from benchmark import harness

CELLS = ("td-4x6-tc", "agent-4x6-d3", "ppo-prod-bf16", "ppo-sb3-f32")


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape_and_correct(tiny, cell):
    root, repo = tiny
    result = harness.run_cell(f"{cell}-tiny", 2 ** 31 + 11, 0.3, False, device="cpu",
                              root=root, repo=repo)
    line = json.loads(json.dumps(result))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    entry = harness.load_entry(harness.load_cell(f"{cell}-tiny", root), root)
    assert set(line["metrics"]) == {entry.rate_metric, "setup_s"}
    assert line["metrics"]["setup_s"]["unit"] == "s"
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"] and all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", ("td-4x6-tc", "ppo-sb3-f32", "agent-4x6-d3"))
def test_traced_run_shape(tiny, cell):
    root, repo = tiny
    result = harness.run_cell(f"{cell}-tiny", 5, 0.3, True, device="cpu", root=root, repo=repo)
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    spec = harness.benchmark_spec(repo)
    names = {m["name"] for m in harness.per_layer_of(f"{cell}-tiny", set(), spec)}
    # without a device trace only the host's spans are read
    assert set(result["metrics"]) <= names
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_program_matches_the_reference_exactly_where_arithmetic_allows(tiny):
    """At tiny sizes on the CPU: the TD learner, the agent and the float32
    PPO agree with the plain reference to rounding; bf16 PPO plays the same
    games."""
    root, repo = tiny
    got = {}
    for cell in CELLS:
        r = harness.run_cell(f"{cell}-tiny", 77, 0.1, False, device="cpu", root=root, repo=repo)
        got[cell] = {k: v["value"] for k, v in r["checks"].items()}
    assert got["td-4x6-tc"] == {"first_gap": 0.0, "change_gap": 0.0}
    assert got["agent-4x6-d3"]["game_mismatches"] == 0
    assert got["agent-4x6-d3"]["action_gap"] < 1e-6
    assert got["ppo-sb3-f32"]["env_mismatches"] == 0
    assert max(got["ppo-sb3-f32"].values()) < 1e-5
    assert got["ppo-prod-bf16"]["env_mismatches"] == 0
