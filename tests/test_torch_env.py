"""The port's batched env (gym2048_tpu_torch.env.batched) against the JAX env.

Both envs start from the same state, carried over with
``gym2048_tpu_torch.interop``, and the test hands the port the uniforms that
the JAX env draws from its key, so one step or reset must agree exactly
(tolerance 0: boards, flags and step counts are integers, and scores are f32
sums of integers below 2**24). The 13 recorded reference trajectories are
replayed through the port's parity mode as tests/test_env.py replays them
through the JAX env.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.env import EnvConfig as JEnvConfig
from gym2048_tpu.env import batched as jbatched
from gym2048_tpu.env import parity
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.env import batched

FIXTURES = json.loads(
    (Path(__file__).parent / "fixtures" / "reference_trajectories.json").read_text()
)
STATE_FIELDS = ("board", "score", "done", "step_count")
TIMESTEP_FIELDS = ("board", "final_board", "reward", "terminated", "truncated",
                   "illegal", "highest", "score", "steps")


def to_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS + ("key",)}


def assert_fields_equal(port, ref, fields, where=""):
    for f in fields:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")


def jax_step_uniforms(state):
    """The ``(B, 6)`` uniforms that ``step_with_products`` draws itself."""
    _, k_u = jax.random.split(state.key)
    return np.array(jax.random.uniform(k_u, (state.board.shape[0], 6)))


@pytest.mark.parametrize("batch", [1, 257])
def test_reset_matches_jax(batch):
    key = jax.random.PRNGKey(batch)
    ref = jbatched.reset(key, batch)
    _, k_u = jax.random.split(key)
    u = torch.as_tensor(np.array(jax.random.uniform(k_u, (batch, 4))))
    port = batched.reset(None, batch, device="cpu", u=u)
    assert_fields_equal(port, ref, STATE_FIELDS, "reset")
    assert (batched.rules.count_empty(port.board) == 14).all()


@pytest.mark.parametrize("config", [
    dict(),
    dict(illegal_move_reward=-1.0, max_tile=64),
    dict(auto_reset=False),
], ids=["default", "imr-max_tile", "no-auto-reset"])
def test_steps_match_jax(config):
    """Eight steps from random boards with random (often illegal) actions,
    both envs fed the same uniforms; every state and TimeStep field equal."""
    n = 512
    rng = np.random.default_rng(0)
    exps = rng.integers(0, 7, size=(n, 4, 4))
    boards = np.where(rng.random((n, 4, 4)) < 0.3, 0, exps).astype(np.int8)
    jstate = dataclasses.replace(jbatched.reset(jax.random.PRNGKey(1), n),
                                 board=jnp.asarray(boards))
    state = interop.env_state_from_numpy(to_numpy(jstate), device="cpu")
    jcfg, cfg = JEnvConfig(**config), batched.EnvConfig(**config)
    terminated = 0
    for i in range(8):
        actions = rng.integers(0, 4, n).astype(np.int32)
        u = jax_step_uniforms(jstate)
        jstate, jts = jbatched.step_with_products(
            jstate, jnp.asarray(actions), jbatched.move_products(jstate), jcfg)
        state, ts = batched.step(state, torch.as_tensor(actions), cfg,
                                 u=torch.as_tensor(u))
        assert_fields_equal(ts, jts, TIMESTEP_FIELDS, f"step {i}")
        assert_fields_equal(state, jstate, STATE_FIELDS, f"step {i}")
        terminated += int(ts.terminated.sum())
    assert terminated > 0


def test_legal_actions_and_products_match_jax():
    n = 300
    rng = np.random.default_rng(2)
    boards = rng.integers(0, 5, size=(n, 4, 4)).astype(np.int8)
    jstate = dataclasses.replace(jbatched.reset(jax.random.PRNGKey(0), n),
                                 board=jnp.asarray(boards))
    state = interop.env_state_from_numpy(to_numpy(jstate), device="cpu")
    np.testing.assert_array_equal(batched.legal_actions(state).numpy(),
                                  np.asarray(jbatched.legal_actions(jstate)))
    for port, ref in zip(batched.move_products(state), jbatched.move_products(jstate)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_generator_drives_steps():
    gen = torch.Generator().manual_seed(0)
    state = batched.reset(gen, 64, device="cpu")
    for _ in range(50):
        legal = batched.legal_actions(state)
        action = torch.where(legal, torch.rand(64, 4, generator=gen), -1.0).argmax(1)
        state, ts = batched.step(state, action, generator=gen)
        assert not ts.illegal.any()
        assert (batched.rules.count_empty(state.board) < 16).all()
    with pytest.raises(ValueError):
        batched.step(state, action)
    with pytest.raises(ValueError):
        batched.reset(None, 4, device="cpu", u=torch.zeros(4, 3))


@pytest.mark.parametrize(
    "imr", sorted({t.get("illegal_move_reward", 0.0) or 0.0
                   for t in FIXTURES["trajectories"]})
)
def test_parity_replay_bit_exact(imr):
    """The recorded reference trajectories through ``step_parity``, with the
    spawns of the reference's own NumPy stream (tests/test_env.py
    ::TestBatchedParityReplay, stepped in a Python loop)."""
    trajs = [t for t in FIXTURES["trajectories"]
             if (t.get("illegal_move_reward", 0.0) or 0.0) == imr]
    B = len(trajs)
    T = max(len(t["steps"]) for t in trajs)
    streams = [parity.ReferenceSpawnStream(t["seed"]) for t in trajs]
    vals0, ranks0 = parity.reset_draws(streams)
    state = batched.reset_parity(torch.as_tensor(vals0), torch.as_tensor(ranks0))
    for b, t in enumerate(trajs):
        np.testing.assert_array_equal(
            batched.rules.exp_to_value(state.board[b]).numpy(), t["board0"])

    actions = np.zeros((T, B), np.int32)
    vals = np.ones((T, B), np.int8)
    ranks = np.tile(np.arange(16, dtype=np.int32), (T, B, 1))
    for b, t in enumerate(trajs):
        for i, st in enumerate(t["steps"]):
            actions[i, b] = st["action"]
            if not st["illegal"]:  # an illegal move consumes no draw
                vals[i, b], ranks[i, b] = streams[b].draw()

    cfg = batched.EnvConfig(illegal_move_reward=imr, auto_reset=False)
    checked = 0
    for i in range(T):
        state, ts = batched.step_parity(state, torch.as_tensor(actions[i]),
                                        torch.as_tensor(vals[i]),
                                        torch.as_tensor(ranks[i]), cfg)
        for b, t in enumerate(trajs):
            if i >= len(t["steps"]):
                continue
            st, where = t["steps"][i], f"seed {t['seed']} step {i}"
            np.testing.assert_array_equal(
                batched.rules.exp_to_value(ts.board[b]).numpy(), st["board"],
                err_msg=where)
            assert ts.reward[b].item() == st["reward"], where
            assert bool(ts.terminated[b]) == st["terminated"], where
            assert bool(ts.illegal[b]) == st["illegal"], where
            assert ts.highest[b].item() == st["highest"], where
            assert ts.score[b].item() == st["score"], where
            checked += 1
    assert checked == sum(len(t["steps"]) for t in trajs)


def test_parity_fixtures_cover_13_trajectories():
    assert len(FIXTURES["trajectories"]) == 13


def test_env_state_from_numpy_drops_key():
    d = to_numpy(jbatched.reset(jax.random.PRNGKey(3), 5))
    state = interop.env_state_from_numpy(d, device="cpu")
    assert [f.name for f in dataclasses.fields(state)] == list(STATE_FIELDS)
    assert state.board.dtype == torch.int8 and state.score.dtype == torch.float32
    assert state.done.dtype == torch.bool and state.step_count.dtype == torch.int32
