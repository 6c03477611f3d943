"""The port's host env (gym2048_tpu_torch.env.adapter, parity, registration,
vector) against the reference fixtures and the JAX package's adapter.

* ``Game2048Env`` replays every trajectory of
  ``tests/fixtures/reference_trajectories.json`` (recorded from the
  reference env) bit for bit, and equals the JAX adapter step by step,
  observations included, under the same seeds and actions.
* Its seeding is gymnasium's without gymnasium: ``parity.np_random`` gives
  the generator of ``gymnasium.utils.seeding.np_random``.
* ``ReferenceSpawnStream`` equals the JAX package's, and feeds the port's
  ``batched.reset_parity`` / ``step_parity``, which replay the fixtures.
* ``Torch2048-v0`` (gymnasium) and ``BatchedVectorEnv`` keep the gymnasium
  contract.

Everything is integer or the same float64 sums: exact.
"""

import json
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium.utils import seeding
from gymnasium.utils.env_checker import check_env

import gym2048_tpu.env  # noqa: F401 — registers the JAX package's ids
from gym2048_tpu.env import adapter as jadapter
from gym2048_tpu.env import parity as jparity
from gym2048_tpu_torch.env import adapter, batched, parity
from gym2048_tpu_torch.env.batched import EnvConfig
from gym2048_tpu_torch.env.registration import ENV_ID, GymGame2048Env
from gym2048_tpu_torch.env.vector import BatchedVectorEnv

FIXTURES = json.loads((Path(__file__).parent / "fixtures" /
                       "reference_trajectories.json").read_text())["trajectories"]


def to_exp(values):
    v = np.asarray(values, np.int64)
    out = np.zeros(v.shape, np.int8)
    out[v > 0] = np.round(np.log2(v[v > 0])).astype(np.int8)
    return out


@pytest.mark.parametrize("idx", range(len(FIXTURES)))
def test_fixture_trajectory_bit_exact(idx):
    traj = FIXTURES[idx]
    env = adapter.Game2048Env()
    if "illegal_move_reward" in traj:
        env.set_illegal_move_reward(traj["illegal_move_reward"])
    env.reset(seed=traj["seed"])
    np.testing.assert_array_equal(env.get_board(), np.asarray(traj["board0"]))
    for i, step in enumerate(traj["steps"]):
        obs, reward, terminated, truncated, info = env.step(step["action"])
        assert (reward, terminated, info["illegal_move"], int(info["highest"]),
                float(env.score)) == (step["reward"], step["terminated"], step["illegal"],
                                      step["highest"], step["score"]), (idx, i)
        np.testing.assert_array_equal(env.get_board(), np.asarray(step["board"]))
        np.testing.assert_array_equal(adapter.unstack_np(obs), env.get_board())


@pytest.mark.parametrize("seed", [0, 7, 2**40])
def test_random_play_equals_the_jax_adapter(seed):
    rng = np.random.default_rng(seed % 1000)
    envs = [adapter.Game2048Env(), jadapter.Game2048Env()]
    for e in envs:
        e.set_illegal_move_reward(-1.0)
        e.set_max_tile(256)
    for episode in range(3):
        # episode 1 resets with seed=None, which keeps each env's generator
        outs = [e.reset(seed=None if episode == 1 else seed + episode) for e in envs]
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        for _ in range(400):
            a = int(rng.integers(0, 4))
            got, want = (e.step(a) for e in envs)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:4] == want[1:4] and got[4]["illegal_move"] == want[4]["illegal_move"]
            assert got[4]["highest"] == want[4]["highest"] and envs[0].score == envs[1].score
            if got[2]:
                break


def test_seeding_is_gymnasiums():
    for seed in (0, 1, 456, 2**63):
        got, got_seed = parity.np_random(seed)
        want, want_seed = seeding.np_random(seed)
        assert got_seed == want_seed
        assert got.bit_generator.state == want.bit_generator.state
        np.testing.assert_array_equal(got.random(8), want.random(8))
    with pytest.raises(ValueError):
        parity.np_random(-1)
    env = adapter.Game2048Env()
    first = env.np_random  # fresh entropy when never seeded
    assert env.np_random is first and env.np_random_seed >= 0
    env.reset(seed=3)
    assert env.np_random is not first and env.np_random_seed == 3
    kept = env.np_random
    env.reset()
    assert env.np_random is kept


def test_reference_spawn_stream_equals_jax():
    for seed in (0, 5, 1234):
        ours, theirs = parity.ReferenceSpawnStream(seed), jparity.ReferenceSpawnStream(seed)
        for _ in range(50):
            (v, r), (jv, jr) = ours.draw(), theirs.draw()
            assert v == jv
            np.testing.assert_array_equal(r, jr)
    streams = [parity.ReferenceSpawnStream(s) for s in (1, 2)]
    jstreams = [jparity.ReferenceSpawnStream(s) for s in (1, 2)]
    for got, want in zip(parity.reset_draws(streams), jparity.reset_draws(jstreams)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("imr", sorted({t.get("illegal_move_reward", 0.0) or 0.0
                                        for t in FIXTURES}))
def test_batched_parity_replays_the_fixtures(imr):
    """The port's ``reset_parity`` / ``step_parity`` fed from the port's
    streams (an illegal step draws nothing) replay every fixture."""
    trajs = [t for t in FIXTURES if (t.get("illegal_move_reward", 0.0) or 0.0) == imr]
    streams = [parity.ReferenceSpawnStream(t["seed"]) for t in trajs]
    vals0, ranks0 = parity.reset_draws(streams)
    state = batched.reset_parity(torch.from_numpy(vals0), torch.from_numpy(ranks0))
    for b, t in enumerate(trajs):
        np.testing.assert_array_equal(state.board[b].numpy(), to_exp(t["board0"]))
    cfg = EnvConfig(illegal_move_reward=imr, auto_reset=False)
    for i in range(max(len(t["steps"]) for t in trajs)):
        actions = np.zeros(len(trajs), np.int64)
        vals = np.ones(len(trajs), np.int8)
        ranks = np.tile(np.arange(16, dtype=np.int32), (len(trajs), 1))
        for b, t in enumerate(trajs):
            if i < len(t["steps"]):
                actions[b] = t["steps"][i]["action"]
                if not t["steps"][i]["illegal"]:
                    vals[b], ranks[b] = streams[b].draw()
        state, ts = batched.step_parity(state, torch.from_numpy(actions), torch.from_numpy(vals),
                                        torch.from_numpy(ranks), cfg)
        for b, t in enumerate(trajs):
            if i >= len(t["steps"]):
                continue
            st = t["steps"][i]
            np.testing.assert_array_equal(ts.board[b].numpy(), to_exp(st["board"]))
            assert (float(ts.reward[b]), bool(ts.terminated[b]), bool(ts.illegal[b]),
                    int(ts.highest[b]), float(ts.score[b])) == (
                st["reward"], st["terminated"], st["illegal"], st["highest"], st["score"])


def test_adapter_contract():
    env = adapter.Game2048Env()
    env.reset(seed=0)
    obs, reward, terminated, truncated, info = env.step(0)
    assert obs.shape == (16, 4, 4) and isinstance(reward, float)
    assert isinstance(terminated, bool) and truncated is False
    env.set_illegal_move_reward(-1.0)
    dead = np.array([[2, 4, 8, 16], [4, 8, 16, 2], [8, 16, 2, 4], [16, 2, 4, 8]])
    env.set_board(dead.copy())
    _, reward, terminated, _, info = env.step(0)
    assert reward == -1.0 and terminated and info["illegal_move"]
    np.testing.assert_array_equal(env.get_board(), dead)
    with pytest.raises(adapter.IllegalMove):
        env.move(0)
    env.set_max_tile(2048)
    env.set_board(np.zeros((4, 4), int))
    env.set(0, 0, 2048)
    assert env.isend() and env.Matrix is env.board
    assert "Score:" in env.render(mode="ansi").getvalue()
    env.set_board(np.full((4, 4), 8192))
    assert env.render(mode="rgb_array").shape == (280, 280, 3)
    assert env.shift([2, 2, 4, 0]) == jadapter.Game2048Env().shift([2, 2, 4, 0])
    assert env.reward_range == (-1.0, float(2**16))
    obs = adapter.stack_np(dead)
    np.testing.assert_array_equal(obs, jadapter.stack_np(dead))
    np.testing.assert_array_equal(adapter.unstack_np(obs), dead)


def test_gym_make_spaces_and_check_env():
    env = gym.make(ENV_ID).unwrapped
    assert isinstance(env, GymGame2048Env) and isinstance(env, adapter.Game2048Env)
    assert env.action_space == gym.spaces.Discrete(4)
    assert env.observation_space.shape == (16, 4, 4)
    assert env.observation_space == gym.make("Tpu2048-v0").unwrapped.observation_space
    check_env(GymGame2048Env(render_mode="rgb_array"), skip_render_check=False)
    # the gymnasium class plays the JAX adapter's game
    env.reset(seed=9)
    jenv = jadapter.Game2048Env()
    jenv.reset(seed=9)
    for a in [0, 1, 2, 3] * 10:
        np.testing.assert_array_equal(env.step(a)[0], jenv.step(a)[0])


def test_batched_vector_env():
    env = BatchedVectorEnv(num_envs=8, config=EnvConfig(illegal_move_reward=-1.0), seed=3,
                           device="cpu")
    assert isinstance(env, gym.vector.VectorEnv)
    obs, info = env.reset(seed=3)
    assert obs.shape == (8, 16, 4, 4) and obs.dtype == np.int64 and info == {}
    assert env.action_space.shape == (8,) and env.observation_space.shape == (8, 16, 4, 4)
    again, _ = env.reset(seed=3)
    np.testing.assert_array_equal(obs, again)
    rng = np.random.default_rng(0)
    terms = 0
    for _ in range(100):
        obs, r, term, trunc, infos = env.step(rng.integers(0, 4, 8))
        assert obs.shape == (8, 16, 4, 4) and r.shape == term.shape == trunc.shape == (8,)
        assert not trunc.any() and {"illegal_move", "highest", "score"} <= set(infos)
        assert (obs.sum(axis=1) == 1).all()
        terms += term.sum()
    assert terms > 0
    assert env.render().shape == (280, 280, 3)
    env.close()
