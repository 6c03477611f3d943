"""The port's rules (gym2048_tpu_torch.core.rules) against the JAX rules.

Every function runs on the same numpy inputs through ``jax.vmap`` of the
JAX function and through the port on the CPU; all outputs are integers, so
they must be equal (tolerance 0). The golden vectors are those of
tests/test_rules.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.core import rules as jrules
from gym2048_tpu_torch.core import rules
import test_rules as golden
from test_rules import MOVE_CASES, SHIFT_CASES, TEST_BOARD, to_exp, to_val


def random_boards(n, seed, max_exp=17, p_zero=0.35):
    rng = np.random.default_rng(seed)
    exps = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def t(x):
    return torch.as_tensor(np.asarray(x))


def assert_same(port, ref):
    ref = np.asarray(ref)
    port = port.numpy()
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("row,expected,score", SHIFT_CASES)
def test_compact_merge_golden(row, expected, score):
    new, s = rules._compact_merge_rows(torch.as_tensor(to_exp(row), dtype=torch.int32))
    assert to_val(new.numpy()).tolist() == expected
    assert int(s) == score


@pytest.mark.parametrize("direction", [0, 1, 2, 3])
def test_move_all_golden(direction):
    moved, scores, changed = rules.move_all(t(to_exp(TEST_BOARD))[None])
    expected, score = MOVE_CASES[direction]
    assert to_val(moved[0, direction].numpy()).tolist() == expected
    assert int(scores[0, direction]) == score
    assert bool(changed[0, direction])


@pytest.mark.parametrize("seed", [0, 1])
def test_move_all_matches_jax(seed):
    boards = random_boards(700, seed)
    for port, ref in zip(rules.move_all(t(boards)),
                         jax.vmap(jrules.move_all)(jnp.asarray(boards))):
        assert_same(port, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_action_matches_jax(seed):
    boards = random_boards(700, seed, max_exp=8, p_zero=0.2)
    actions = np.random.default_rng(seed).integers(0, 4, 700).astype(np.int32)
    port = rules.apply_action(t(boards), t(actions))
    ref = jax.vmap(jrules.apply_action)(jnp.asarray(boards), jnp.asarray(actions))
    for p, r in zip(port, ref):
        assert_same(p, r)
    assert not port[2].all() and port[2].any()  # both legal and illegal moves


def test_is_dead_highest_count_empty_match_jax():
    boards = np.concatenate([
        random_boards(500, 3, max_exp=6, p_zero=0.05),
        to_exp([golden.TestTerminal.FULL_DEAD, golden.TestTerminal.FULL_MERGEABLE]),
        np.zeros((1, 4, 4), np.int8),
    ])
    jb = jnp.asarray(boards)
    for fn in ("is_dead", "highest", "count_empty"):
        assert_same(getattr(rules, fn)(t(boards)), jax.vmap(getattr(jrules, fn))(jb))
    dead = rules.is_dead(t(boards))
    assert dead[-3] and not dead[-2] and not dead[-1]


@pytest.mark.parametrize("p_zero", [0.0, 0.3, 0.9, 1.0])
def test_spawn_matches_jax(p_zero):
    n = 600
    rng = np.random.default_rng(int(p_zero * 10))
    boards = random_boards(n, 4, max_exp=9, p_zero=p_zero)
    u = rng.random((n, 2)).astype(np.float32)
    # edges of the f32 law: 0, the largest float below 1, around 0.9f
    u[:8] = np.asarray([[0.0, 0.0], [np.float32(1) - np.float32(2**-24)] * 2,
                        [0.9, 0.5], [np.nextafter(np.float32(0.9), 0), 0.999],
                        [0.95, 0.25], [0.1, 0.75], [0.5, 0.3], [0.89, 0.1]],
                       np.float32)
    port = rules.spawn(t(boards), t(u[:, 0]), t(u[:, 1]))
    ref = jax.vmap(jrules.spawn)(jnp.asarray(boards), jnp.asarray(u[:, 0]),
                                 jnp.asarray(u[:, 1]))
    assert_same(port, ref)


def test_spawn_ranked_matches_jax():
    n = 300
    rng = np.random.default_rng(5)
    boards = random_boards(n, 5, max_exp=7, p_zero=0.5)
    boards[:3] = random_boards(3, 6, max_exp=7, p_zero=0.0)  # full boards
    vals = rng.integers(1, 3, n).astype(np.int8)
    ranks = np.argsort(rng.random((n, 16)), axis=1).astype(np.int32)
    port = rules.spawn_ranked(t(boards), t(vals), t(ranks))
    ref = jax.vmap(jrules.spawn_ranked)(jnp.asarray(boards), jnp.asarray(vals),
                                        jnp.asarray(ranks))
    assert_same(port, ref)


def test_exp_value_round_trip_matches_jax():
    boards = random_boards(400, 7, max_exp=17)
    values = rules.exp_to_value(t(boards))
    assert_same(values, jax.vmap(jrules.exp_to_value)(jnp.asarray(boards)))
    assert_same(rules.value_to_exp(values),
                jax.vmap(jrules.value_to_exp)(jnp.asarray(values.numpy())))
    np.testing.assert_array_equal(rules.value_to_exp(values).numpy(), boards)
