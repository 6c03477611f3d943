"""The port's determinism and safety utilities (gym2048_tpu_torch.utils.debug)
against gym2048_tpu.utils.debug (mirrors tests/test_debug.py): the same
mask, the same fingerprint integer, exactly; and the cross-topology
fingerprint of a real 2-rank gloo PPO rollout, collected, against the
single-process rollout of the same seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import run_workers

from gym2048_tpu.env import batched as jbatched
from gym2048_tpu.utils import debug as jdebug
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.models.resnet import ActorCritic
from gym2048_tpu_torch.train import ppo
from gym2048_tpu_torch.utils import debug


def boards():
    """Valid boards, then invalid ones: an exponent out of range, a negative
    one, an empty board, 17 (past the range)."""
    rng = np.random.default_rng(0)
    good = rng.integers(0, 12, (16, 4, 4)).astype(np.int8)
    good[:, 0, 0] = 1
    bad = np.zeros((4, 4, 4), np.int8)
    bad[0] = 30
    bad[1, 2, 2], bad[1, 0, 0] = -1, 3
    bad[3, 1, 1] = 17
    return good, bad


def test_validate_boards_matches_jax():
    good, bad = boards()
    for b in (good, bad, np.concatenate([good, bad])):
        want = np.asarray(jdebug.validate_boards(jnp.asarray(b), enabled=False))
        got = debug.validate_boards(torch.from_numpy(b), enabled=False)
        np.testing.assert_array_equal(got.numpy(), want)
    assert debug.validate_boards(torch.from_numpy(good)).all()
    with pytest.raises(ValueError, match="invalid board state detected"):
        debug.validate_boards(torch.from_numpy(bad))
    state = batched.reset(torch.Generator().manual_seed(0), 16, device="cpu")
    assert debug.validate_boards(state.board).all()
    # a single board too
    assert bool(debug.validate_boards(torch.from_numpy(good[0])))


@dataclasses.dataclass
class Leaf:
    x: torch.Tensor
    y: list


def test_assert_finite_tree_walks_every_container():
    tree = {"a": torch.ones(3), "b": np.zeros(2), "c": [1.0, (torch.arange(3),)],
            "d": Leaf(torch.zeros(2), [np.ones(1)])}
    debug.assert_finite_tree(tree)
    with pytest.raises(FloatingPointError, match=r"tree\['a'\]"):
        debug.assert_finite_tree({"a": torch.tensor([1.0, float("nan")])})
    with pytest.raises(FloatingPointError, match=r"state\['d'\]\.y\[0\]"):
        debug.assert_finite_tree({**tree, "d": Leaf(torch.zeros(2), [np.array([np.inf])])},
                                 "state")
    with pytest.raises(FloatingPointError, match=r"\['c'\]\[0\]"):
        debug.assert_finite_tree({"c": [float("-inf")]})
    # a module and an optimiser through their state dicts, in a TrainState
    trainer = ppo.PPO(ppo.PPOConfig(n_envs=4, n_steps=4, batch_size=8, filters=8,
                                    residual_blocks=1), device="cpu")
    state = trainer.init_state()
    debug.assert_finite_tree(state, "ppo")
    with torch.no_grad():
        state.model.value_head.bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match=r"ppo\.model\['value_head\.bias'\]"):
        debug.assert_finite_tree(state, "ppo")
    model = ActorCritic(8, 1, device="cpu")
    with torch.no_grad():
        model.res_blocks[0].bn1.running_var[0] = float("inf")
    with pytest.raises(FloatingPointError, match="running_var"):
        debug.assert_finite_tree(model)


def test_fingerprint_matches_jax():
    rng = np.random.default_rng(3)
    b = rng.integers(0, 16, (30, 32, 4, 4)).astype(np.int8)
    r = (rng.integers(0, 2000, (30, 32)) + rng.integers(0, 16, (30, 32)) / 16).astype(np.float32)
    d = rng.random((30, 32)) < 0.05
    want = jdebug.trajectory_fingerprint(jnp.asarray(b), jnp.asarray(r), jnp.asarray(d))
    assert debug.trajectory_fingerprint(torch.from_numpy(b), torch.from_numpy(r),
                                        torch.from_numpy(d)) == want
    assert debug.trajectory_fingerprint(b, r, d) == want
    # order-independent, and a different trajectory differs
    assert debug.trajectory_fingerprint(b[::-1], r[::-1], d[::-1]) == want
    assert debug.trajectory_fingerprint(b, r + 1, d) != want


def test_fingerprint_of_jax_rollout():
    """A JAX batched-env rollout's arrays carried across give JAX's integer."""
    def body(s, _):
        act = jax.random.categorical(jax.random.fold_in(s.key, 5),
                                     jnp.where(jbatched.legal_actions(s), 0.0, -1e9), axis=-1)
        s, ts = jbatched.step(s, act)
        return s, (ts.board, ts.reward, ts.terminated)

    _, (b, r, d) = jax.lax.scan(body, jbatched.reset(jax.random.PRNGKey(9), 16), None, length=20)
    want = jdebug.trajectory_fingerprint(b, r, d)
    got = debug.trajectory_fingerprint(*(torch.from_numpy(np.array(x)) for x in (b, r, d)))
    assert got == want


def test_two_rank_rollout_fingerprint_is_the_single_process_one(tmp_path):
    """A real 2-rank gloo PPO iteration (tests/torch_dp_worker.py): each
    rank's rollout, collected, has the fingerprint of the single-process
    rollout of the same seed; a different seed's differs."""
    import torch_dp_worker

    results = run_workers(2, tmp_path, "ppo")
    fingerprints = {debug.trajectory_fingerprint(*res["ppo"]["rollout"]) for res in results}
    for seed in (torch_dp_worker.PPO_CONFIG["seed"], 99):
        trainer = ppo.PPO(ppo.PPOConfig(**{**torch_dp_worker.PPO_CONFIG, "seed": seed}),
                          device="cpu")
        traj, _ = trainer._collect_rollout(trainer.init_state())
        single = debug.trajectory_fingerprint(traj.board, traj.reward, traj.done)
        if seed == 99:
            assert fingerprints != {single}
        else:
            assert fingerprints == {single}
