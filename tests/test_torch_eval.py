"""The port's batched evaluator (gym2048_tpu_torch.train.eval) and the
critic as a search leaf (gym2048_tpu_torch.agents.expectimax.
value_leaf_from_critic) against the JAX package's.

Tolerances, with their reasons:

* ``make_predict_fn``: within 1e-6 (probabilities): the eval-mode forward
  agrees to f32 roundoff (tests/test_torch_resnet.py).
* The critic leaf's Q-values on ``docs/curves/ppo_masked_model.pkl``:
  within 1e-5 of the largest magnitude: f32 roundoff of the critic (values
  in the thousands) and of the expectation over 32 spawns; the port runs
  the N leaves in one forward, JAX one board at a time under ``vmap``.
* ``choose_action``, ``report_evaluation_results``: equal.
* ``evaluate_batched`` draws its own spawns and actions (another stream),
  so it is held to the protocol's invariants, and the committed model to
  its recorded average within 3 standard errors (``-m slow``).
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.agents import expectimax as jex
from gym2048_tpu.models import ActorCritic as JActorCritic
from gym2048_tpu.models import Game2048Model as JGame2048Model
from gym2048_tpu.train import eval as jeval
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.agents import expectimax as ex
from gym2048_tpu_torch.models.resnet import ActorCritic, Game2048Model
from gym2048_tpu_torch.ops import obs as obs_ops
from gym2048_tpu_torch.train import eval as teval
from gym2048_tpu_torch.utils import checkpoint

MASKED_MODEL = "docs/curves/ppo_masked_model.pkl"
MASKED_EVAL = "docs/curves/ppo_masked_eval.json"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contending with each other
    ran a training test 30 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def boards(n, seed, max_exp=11, p_zero=0.4):
    rng = np.random.default_rng(seed)
    b = rng.integers(1, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, b).astype(np.int8)


def small_models(kind):
    """A JAX model, its variables, and the port's model holding them."""
    jm = JActorCritic(8, 1) if kind == "ActorCritic" else JGame2048Model(filters=8,
                                                                        residual_blocks=1)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5),
                                                 jnp.zeros((1, 4, 4, 16), jnp.float32)))
    return jm, variables, interop.resnet_from_variables(variables, device="cpu")


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_make_predict_fn_matches_jax(kind):
    jm, variables, model = small_models(kind)
    want_fn = jeval.make_predict_fn(jm, variables)
    got_fn = teval.make_predict_fn(model)
    for b in boards(8, 1):
        observation = obs_ops.env_stack(torch.from_numpy(b)).numpy()
        got, want = got_fn(observation), np.asarray(want_fn(observation))
        assert got.shape == (4,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_choose_action_makes_the_same_choices():
    jm, variables, model = small_models("ActorCritic")
    jfn, tfn = jeval.make_predict_fn(jm, variables), teval.make_predict_fn(model)
    observations = [obs_ops.env_stack(torch.from_numpy(b)).numpy() for b in boards(40, 2)]
    choices = []
    for module, fn in ((jeval, jfn), (teval, tfn)):
        random.seed(123)
        choices.append([module.choose_action(fn, o, epsilon=0.4) for o in observations])
    assert choices[0] == choices[1]
    assert len(set(choices[0])) > 1


def test_report_evaluation_results_writes_the_same_bytes(tmp_path, monkeypatch):
    results = {"Episodes": [
        {"total_reward": 1234.0, "highest": 128, "moves": 150, "illegal_moves": 1},
        {"total_reward": -1.0, "highest": 4, "moves": 1, "illegal_moves": 1},
        {"total_reward": 0.5, "highest": 2048, "moves": 2001, "illegal_moves": 0}]}
    written = []
    for name, module in (("jax", jeval), ("port", teval)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        module.report_evaluation_results(results, label="unit")
        written.append((tmp_path / name / "scores_unit.csv").read_bytes())
    assert written[0] == written[1]


def test_host_evaluator_names_its_queue_item():
    for fn in (teval.evaluate_episode, teval.evaluate_model):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            fn(None, 1, 0.0)


@pytest.mark.parametrize("mask_illegal", [False, True])
@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_evaluate_batched_keeps_the_protocol(kind, mask_illegal):
    """Invariants of the protocol on a small untrained model: at most
    ``move_cap + 1`` moves an episode, tiles powers of two, the reward the
    sum of merges less one per illegal move, no illegal move under the
    mask (and then every episode runs to the cap or to a dead board), at
    most one without it (an illegal move ends the episode)."""
    _, _, model = small_models(kind)
    cap = 40
    res = teval.evaluate_batched(model, 48, 0.2, torch.Generator().manual_seed(1),
                                 move_cap=cap, mask_illegal=mask_illegal)
    eps = res["Episodes"]
    assert len(eps) == 48 and set(res) == {"Average score", "Max score", "Highest tile",
                                           "Episodes"}
    moves = np.array([e["moves"] for e in eps])
    illegal = np.array([e["illegal_moves"] for e in eps])
    highest = np.array([e["highest"] for e in eps])
    total = np.array([e["total_reward"] for e in eps])
    assert moves.min() >= 1 and moves.max() <= cap + 1
    assert np.all((highest & (highest - 1)) == 0) and highest.min() >= 2
    assert res["Highest tile"] == highest.max()
    assert res["Average score"] == pytest.approx(total.mean())
    assert res["Max score"] == total.max()
    merges = total + illegal  # merge scores are sums of tiles >= 4, or 0
    assert np.all(merges >= 0) and np.all(merges % 2 == 0)
    if mask_illegal:
        assert illegal.sum() == 0
    else:
        assert illegal.max() <= 1
    # the same generator seed gives the same episodes
    again = teval.evaluate_batched(model, 48, 0.2, torch.Generator().manual_seed(1),
                                   move_cap=cap, mask_illegal=mask_illegal)
    assert again == res


def test_evaluate_batched_random_policy_statistics():
    """epsilon 1 with the mask is uniform random legal play: the average
    score of random 2048 (~1,000, tiles peaking at 64-128)."""
    _, _, model = small_models("ActorCritic")
    res = teval.evaluate_batched(model, 128, 1.0, torch.Generator().manual_seed(2),
                                 mask_illegal=True)
    assert 600 < res["Average score"] < 1600
    assert max(e["moves"] for e in res["Episodes"]) < 400


def masked_model():
    variables, meta = checkpoint.load_model(MASKED_MODEL)
    return variables, meta, interop.resnet_from_variables(variables, device="cpu")


def test_critic_leaf_q_values_match_jax():
    """``make_policy(1, value_leaf_from_critic(model), gain_weight=1.0,
    dead_value=bellman_dead_value)`` over the committed masked PPO model on
    16 boards: the Q-values of ``action_values`` and the actions."""
    variables, meta, model = masked_model()
    b = boards(16, 3)
    jleaf = jex.value_leaf_from_critic(JActorCritic(meta["filters"], meta["residual_blocks"]),
                                       variables)
    want = np.asarray(jax.jit(jax.vmap(lambda x: jex.action_values(
        x, 1, jleaf, 1.0, jex.bellman_dead_value)))(jnp.asarray(b)))
    leaf = ex.value_leaf_from_critic(model)
    got = ex.action_values(torch.from_numpy(b), 1, leaf, 1.0, ex.bellman_dead_value).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    actions = ex.make_policy(1, leaf, gain_weight=1.0, dead_value=ex.bellman_dead_value)(
        torch.from_numpy(b))
    np.testing.assert_array_equal(actions.numpy(), want.argmax(-1))
    # one leaf call is one forward over all its boards
    values = leaf(torch.from_numpy(b))
    assert values.shape == (16,) and values.dtype == torch.float32
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        leaf(torch.from_numpy(b))


@pytest.mark.slow
def test_committed_masked_model_scores_its_recorded_average():
    """``ppo_masked_model.pkl`` through the port's ``evaluate_batched``
    (512 games, epsilon 0, the mask) against its recorded average
    (``ppo_masked_eval.json``: 10,099.3) within 3 standard errors of the
    port's mean."""
    recorded = json.loads(open(MASKED_EVAL).read())
    torch.set_num_threads(min(8, os.cpu_count()))  # the module fixture restores it
    _, _, model = masked_model()
    res = teval.evaluate_batched(model, 512, 0.0, torch.Generator().manual_seed(0),
                                 mask_illegal=True)
    scores = np.array([e["total_reward"] for e in res["Episodes"]])
    sem = scores.std(ddof=1) / np.sqrt(len(scores))
    assert abs(res["Average score"] - recorded["Average score"]) <= 3 * sem, (
        res["Average score"], sem)
    assert sum(e["illegal_moves"] for e in res["Episodes"]) == 0
