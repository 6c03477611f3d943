"""The port's expectimax agents (gym2048_tpu_torch.agents.expectimax) against
gym2048_tpu.agents.expectimax on the same numpy inputs.

Tolerances, with their reasons:

* the heuristic and the spawn children are integer sums and f32 products
  taken in one fixed order on both sides: equal bit for bit;
* the searches take f32 spawn expectations over 32 children, which the two
  frameworks may add in different orders. The heuristic search
  (``action_values``) is held to rtol 1e-5; the afterstate search over a
  table of small non-negative integers (values and scores >= 0, so no sum
  cancels) to rtol 1e-6, and its actions must agree wherever the best two
  Q-values of a board differ by more than that;
* games draw their spawns from different generators in the two packages,
  so whole games are compared by their statistics: mean length and score
  within 4 standard errors.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.agents import expectimax as jx
from gym2048_tpu.models import ntuple_big as jnb
from gym2048_tpu.utils.checkpoint import save_model
from gym2048_tpu_torch.agents import expectimax as tx
from gym2048_tpu_torch.core import rules as trules
from gym2048_tpu_torch.models import ntuple_big as tnb

# a small staged network: two 4-cell tuples, stages at exponents 6 and 8
TUPLES = ((0, 1, 2, 3), (0, 1, 4, 5))
THRESHOLDS = (6, 8)
JNET = jnb.NTupleNetwork(TUPLES, 16, THRESHOLDS)
TNET = tnb.NTupleNetwork(TUPLES, 16, THRESHOLDS)


def int_table(seed=0, high=64):
    """Small non-negative integers: every value sum is exact."""
    return np.random.default_rng(seed).integers(0, high, JNET.table_size).astype(np.float32)


def boards(n, seed, max_exp=7, p_zero=0.4):
    rng = np.random.default_rng(seed)
    exps = rng.integers(1, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def special_boards():
    """A dead board, a board with one legal move, and a merge-rich board."""
    dead = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 4], [5, 6, 7, 8]])
    one_move = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 4], [5, 6, 7, 0]])
    merges = np.array([[1, 1, 2, 3], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])
    return np.stack([dead, one_move, merges]).astype(np.int8)


def assert_q_close(got, want, rtol):
    """Q-values within ``rtol``; actions equal wherever the best two Q of a
    board differ by more than that."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol)
    top2 = np.sort(want, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > rtol * np.abs(top2[:, 1])
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    assert clear.any()


def test_heuristic_value_and_spawn_children_match_jax():
    b = np.concatenate([boards(64, 0, max_exp=15), special_boards()])
    np.testing.assert_array_equal(
        tx.heuristic_value(torch.from_numpy(b)).numpy(),
        np.asarray(jax.vmap(jx.heuristic_value)(jnp.asarray(b))))
    np.testing.assert_array_equal(
        tx.heuristic_dead_value(torch.from_numpy(b)).numpy(),
        np.asarray(jax.vmap(jx.heuristic_dead_value)(jnp.asarray(b))))
    children, probs = tx.spawn_children(torch.from_numpy(b))
    jc, jp = jax.vmap(jx.spawn_children)(jnp.asarray(b))
    assert children.dtype == torch.int8 and probs.dtype == torch.float32
    np.testing.assert_array_equal(children.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(probs.numpy(), np.asarray(jp))
    assert tx.bellman_dead_value(torch.from_numpy(b)).abs().sum().item() == 0.0


@pytest.mark.parametrize("depth", [1, 2])
def test_action_values_match_jax(depth):
    b = np.concatenate([boards(3, 1), special_boards()])
    want = jax.jit(jax.vmap(partial(jx.action_values, depth=depth)))(jnp.asarray(b))
    got = tx.action_values(torch.from_numpy(b), depth)
    assert_q_close(got.numpy(), want, rtol=1e-5)
    assert (got[3] == tx._NEG).all()  # the dead board
    actions = tx.make_policy(depth)(torch.from_numpy(b))
    assert actions.dtype == torch.int32
    np.testing.assert_array_equal(actions.numpy(), np.asarray(want).argmax(-1))


def test_action_values_depth3_matches_jax():
    """Depth 3 runs the port's per-slice loop over the 32 spawn slices; two
    boards of 11 tiles keep the JAX search cheap."""
    rng = np.random.default_rng(21)
    b = np.zeros((2, 16), np.int8)
    for row in b:
        row[rng.choice(16, 11, replace=False)] = rng.integers(1, 8, 11)
    b = b.reshape(2, 4, 4)
    want = jax.jit(jax.vmap(partial(jx.action_values, depth=3)))(jnp.asarray(b))
    got = tx.action_values(torch.from_numpy(b), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    assert (got > tx._NEG).sum() >= 4  # legal moves were searched


@pytest.mark.parametrize("plies, beam, map_spawn", [
    (1, False, True), (2, False, True), (2, True, True),
    (3, False, True), (3, True, True), (3, True, False)])
def test_afterstate_search_matches_jax(plies, beam, map_spawn):
    table = int_table()
    b = np.concatenate([boards(3, 2 + plies), special_boards()])
    jvf = lambda bs: JNET.value_batch(jnp.asarray(table), bs)
    want = jax.jit(lambda x: jx._afterstate_search(jvf, x, plies, beam, map_spawn))(
        jnp.asarray(b))
    tvf = TNET.make_value_fn(torch.from_numpy(table))
    got = tx._afterstate_search(tvf, torch.from_numpy(b), plies, beam, map_spawn)
    assert got.dtype == torch.float32 and got.shape == (len(b), 4)
    assert_q_close(got.numpy(), want, rtol=1e-6)


def test_afterstate_policy_matches_jax_and_is_legal():
    table = int_table(1)
    b = boards(16, 9)
    jpol = jx.make_afterstate_policy(lambda t, bs: JNET.value_batch(t, bs), depth=2,
                                     parametrised=True)
    tpol = tx.make_afterstate_policy(TNET.value_batch, depth=2, parametrised=True)
    got = tpol(torch.from_numpy(table), torch.from_numpy(b))
    want = jax.jit(jpol)(jnp.asarray(table), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    legal = trules.move_all(torch.from_numpy(b))[2]
    assert legal.gather(1, got[:, None].long()).all()
    with pytest.raises(ValueError):
        tx.make_afterstate_policy(TNET.value_batch, depth=4)


def tie_boards():
    """Eight boards; boards 1, 3, 4 and 6 tie at 5 empty cells, boards 2 and
    5 at 6; board 0 is open and board 7 has 5 empties but is not live."""
    rng = np.random.default_rng(21)
    out = []
    for empties in (12, 5, 6, 5, 5, 6, 5, 5):
        tiles = rng.integers(1, 8, size=16)
        tiles[rng.permutation(16)[:empties]] = 0
        out.append(tiles.reshape(4, 4))
    return np.stack(out).astype(np.int8), np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)


@pytest.mark.parametrize("k_deep", [1, 3, 5, 8])
def test_adaptive_deep_set_breaks_ties_like_jax(k_deep):
    b, active = tie_boards()
    top, take = tx._deep_set(torch.from_numpy(b), torch.from_numpy(active), k_deep, 6)
    # the deep set as make_adaptive_policy computes it
    empties = (jnp.asarray(b).reshape(8, 16) == 0).sum(-1)
    eligible = jnp.asarray(active) & (empties <= 6)
    danger = jnp.where(eligible, -empties, -(10 ** 6))
    _, jtop = jax.lax.top_k(danger, min(k_deep, 8))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(take.numpy(), np.asarray(eligible[jtop]))


def test_adaptive_policy_matches_jax_under_ties():
    table = int_table(2)
    b, active = tie_boards()
    jpol = jx.make_adaptive_policy(lambda t, bs: JNET.value_batch(t, bs), 3, deep_empty_max=6)
    tpol = tx.make_adaptive_policy(TNET.value_batch, 3, deep_empty_max=6)
    want = jax.jit(jpol)(jnp.asarray(table), jnp.asarray(b), jnp.asarray(active))
    got = tpol(torch.from_numpy(table), torch.from_numpy(b), torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_depth3_zero_table_picks_merge():
    b = torch.from_numpy(special_boards()[2:])
    zero = lambda _t, bs: torch.zeros(bs.shape[0])
    p3 = tx.make_afterstate_policy(zero, depth=3, parametrised=True)
    assert int(p3(torch.zeros(4), b)[0]) in (trules.LEFT, trules.RIGHT)


def test_everyone_deep_matches_depth3_beam():
    table = torch.from_numpy(int_table(3))
    b = torch.from_numpy(boards(6, 12))
    adaptive = tx.make_adaptive_policy(TNET.value_batch, 6, deep_empty_max=16)
    plain = tx.make_afterstate_policy(TNET.value_batch, depth=3, parametrised=True, beam=True)
    np.testing.assert_array_equal(adaptive(table, b, torch.ones(6, dtype=torch.bool)).numpy(),
                                  plain(table, b).numpy())


def test_no_eligible_matches_depth2():
    table = torch.from_numpy(int_table(4))
    b = torch.from_numpy(boards(6, 13))
    adaptive = tx.make_adaptive_policy(TNET.value_batch, 3, deep_empty_max=-1)
    d2 = tx.make_afterstate_policy(TNET.value_batch, depth=2, parametrised=True)
    np.testing.assert_array_equal(adaptive(table, b, torch.ones(6, dtype=torch.bool)).numpy(),
                                  d2(table, b).numpy())


def test_greedy_play_statistics_match_jax():
    """64 greedy (depth-1) games over the same table in both packages."""
    table = int_table(5, high=1000)
    jres = jx.play_policy(
        jx.make_afterstate_policy(lambda t, bs: JNET.value_batch(t, bs), depth=1,
                                  parametrised=True),
        64, jax.random.PRNGKey(0), move_cap=4096, params=jnp.asarray(table))
    tres = tx.play_policy(
        tx.make_afterstate_policy(TNET.value_batch, depth=1, parametrised=True),
        64, torch.Generator().manual_seed(0), move_cap=4096,
        params=torch.from_numpy(table), device="cpu")
    for key in ("moves", "total_reward"):
        a = np.array([e[key] for e in jres["Episodes"]], np.float64)
        c = np.array([e[key] for e in tres["Episodes"]], np.float64)
        se = np.sqrt(a.var(ddof=1) / len(a) + c.var(ddof=1) / len(c))
        assert abs(a.mean() - c.mean()) < 4 * se, (key, a.mean(), c.mean(), se)
    assert tres["Average score"] == pytest.approx(
        np.mean([e["total_reward"] for e in tres["Episodes"]]))
    assert tres["Highest tile"] == max(e["highest"] for e in tres["Episodes"])


def test_play_policy_needs_active_and_move_cap():
    seen = []

    def policy(params, boards_, active):
        seen.append(active.clone())
        return torch.zeros(boards_.shape[0], dtype=torch.int32)

    res = tx.play_policy(policy, 4, torch.Generator().manual_seed(1), move_cap=8,
                         chunk_moves=4, params=torch.zeros(1), needs_active=True,
                         device="cpu")
    assert len(seen) in (4, 8) and len(res["Episodes"]) == 4
    assert all(e["moves"] == int(sum(s[i] for s in seen)) for i, e in enumerate(res["Episodes"]))


def test_cli_heuristic_on_cpu(capsys):
    tx.main(["--episodes", "4", "--depth", "1", "--move-cap", "60", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["episodes"] == 4 and out["device"] == "cpu" and out["Average score"] >= 0


@pytest.mark.parametrize("mode", [["--depth", "1"], ["--adaptive", "2"]])
def test_cli_table_mode_on_cpu(tmp_path, capsys, mode):
    path = tmp_path / "table.pkl"
    save_model(path, {"table": int_table(6)},
               {"config": {"tuples": [list(t) for t in TUPLES], "n_vals": 16,
                           "thresholds": list(THRESHOLDS)}})
    tx.main(["--episodes", "2", "--move-cap", "16", "--chunk-moves", "8",
             "--table", str(path), "--device", "cpu", *mode])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["episodes"] == 2 and out["Average score"] >= 0


def test_cli_small_table_names_the_later_slice(tmp_path, capsys):
    path = tmp_path / "small.pkl"
    save_model(path, {"table": np.zeros(8, np.float32)})
    with pytest.raises(SystemExit):
        tx.main(["--table", str(path), "--device", "cpu"])
    assert "not ported yet" in capsys.readouterr().err


def test_play_batched_on_cpu():
    """The move cap is checked after each chunk of 128 moves, as in JAX."""
    res = tx.play_batched(2, depth=1, generator=torch.Generator().manual_seed(3),
                          move_cap=32, device="cpu")
    assert len(res["Episodes"]) == 2 and all(e["moves"] <= 128 for e in res["Episodes"])
