"""Evaluation harness (counterpart of ``gym2048_tpu/train/eval.py``).

Protocol (the reference's, train.py:122-229): episodes on a fresh env with
illegal-move reward -1, epsilon-greedy over the policy's argmax, env seed
``456+i`` / agent seed ``123+i``, a 2000-move cap; the result reports the
average and max total reward and the highest tile, and
:func:`report_evaluation_results` writes ``scores_<label>.csv``.

* :func:`make_predict_fn` and :func:`choose_action`: the one-observation
  policy, with Python's ``random`` in the reference's call order;
* :func:`evaluate_episode` and :func:`evaluate_model`: the host loop over
  the numpy adapter (``env/adapter.py``), one model call per move, bit-exact
  to the reference's NumPy streams for a given ``predict_fn``;
* :func:`evaluate_batched`: all episodes at once on the model's device,
  with its random draws from a ``torch.Generator`` (the same laws as the
  JAX evaluator's keys, another stream).
"""

from __future__ import annotations

import csv
import random
from typing import Callable

import numpy as np
import torch

from gym2048_tpu_torch.env import adapter, batched
from gym2048_tpu_torch.env.batched import EnvConfig
from gym2048_tpu_torch.models.resnet import ActorCritic, boards_to_model_input
from gym2048_tpu_torch.ops import obs as obs_ops

MOVE_CAP = 2000  # the reference's cap
_CHECK_EVERY = 16  # lockstep moves between host reads of "any episode live"
_TINY = torch.finfo(torch.float32).tiny


def _policy_logits(model, obs: torch.Tensor) -> torch.Tensor:
    """Logits of either model: the ActorCritic's policy head, or the log
    of the Game2048Model's probabilities (floored at 1e-30), as in JAX."""
    out = model(obs)
    if isinstance(model, ActorCritic):
        return out[0]
    return torch.log(out.clamp_min(1e-30))


def make_predict_fn(model) -> Callable[[np.ndarray], np.ndarray]:
    """One-observation probability function of ``model``, which must be in
    eval mode (JAX's ``train=False``): the ``(16, 4, 4)`` env observation ->
    probabilities ``(4,)`` as numpy, from one batch-1 forward on the
    model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict(observation: np.ndarray) -> np.ndarray:
        if model.training:
            raise ValueError("make_predict_fn needs the model in eval mode (model.eval())")
        board = obs_ops.unstack_env(torch.as_tensor(np.asarray(observation)))
        obs = boards_to_model_input(board[None].to(device))
        if isinstance(model, ActorCritic):
            probs = torch.softmax(model(obs)[0][0], -1)
        else:
            probs = model(obs)[0]
        return probs.cpu().numpy()

    return predict


def choose_action(predict_fn, observation: np.ndarray, epsilon: float = 0.0) -> int:
    """Epsilon-greedy action, with Python ``random`` in the reference's
    call order (one ``uniform``, then ``randint`` when exploring)."""
    predictions = predict_fn(observation)
    if random.uniform(0, 1) > epsilon:
        return int(np.argmax(predictions))
    return random.randint(0, 3)


def evaluate_episode(predict_fn, env: adapter.Game2048Env, epsilon: float,
                     seed: int | None = None, agent_seed: int | None = None
                     ) -> tuple[float, int, int, int]:
    """One evaluation episode (reference train.py:122-165): Python's
    ``random`` seeded ``agent_seed`` (fresh entropy if None), ``env`` reset
    with ``seed``, at most ``MOVE_CAP + 1`` moves. Returns ``(total_reward,
    moves_taken, total_illegals, highest_tile)``."""
    if agent_seed is not None:
        random.seed(agent_seed)
    else:
        random.seed()

    total_reward = 0.0
    total_illegals = 0
    moves_taken = 0

    state, _ = env.reset(seed=seed)
    info = {"highest": env.highest()}
    while True:
        action = choose_action(predict_fn, state, epsilon)
        next_state, reward, terminated, truncated, info = env.step(action)
        done = terminated or truncated
        total_reward += reward
        if info["illegal_move"]:
            total_illegals += 1
        moves_taken += 1
        if moves_taken > MOVE_CAP:
            break
        state = next_state
        if done:
            break

    return total_reward, moves_taken, total_illegals, int(info["highest"])


def evaluate_model(predict_fn, episodes: int, epsilon: float, verbose: bool = True) -> dict:
    """``episodes`` host episodes of the reference protocol (reference
    train.py:168-214) on one :class:`~gym2048_tpu_torch.env.adapter.
    Game2048Env` with illegal reward -1, episode i with env seed ``456+i``
    and agent seed ``123+i``."""
    env = adapter.Game2048Env()
    env.set_illegal_move_reward(-1.0)

    scores = []
    for i in range(episodes):
        total_reward, moves, illegals, highest = evaluate_episode(
            predict_fn, env, epsilon, seed=456 + i, agent_seed=123 + i)
        if verbose:
            print(f"Episode {i}, epsilon {epsilon}, highest {highest}, "
                  f"reward {total_reward:.1f}, moves {moves}, illegals {illegals}")
        scores.append({"total_reward": total_reward, "highest": highest, "moves": moves,
                       "illegal_moves": illegals})

    average_score = sum(s["total_reward"] for s in scores) / episodes
    max_score = max(s["total_reward"] for s in scores)
    highest_tile = max(s["highest"] for s in scores)
    if verbose:
        print(f"Highest tile: {highest_tile}, Average score: {average_score:.1f}, "
              f"Max score: {max_score:.1f}")
    return {"Average score": average_score, "Max score": max_score,
            "Highest tile": highest_tile, "Episodes": scores}


def report_evaluation_results(results: dict, label: str = "eval") -> None:
    """Write ``scores_<label>.csv`` in the working directory."""
    with open(f"scores_{label}.csv", "w") as f:
        fieldnames = ["total_reward", "highest", "moves", "illegal_moves"]
        writer = csv.DictWriter(f, fieldnames=fieldnames, lineterminator="\n")
        writer.writeheader()
        for s in results["Episodes"]:
            writer.writerow(s)


@torch.no_grad()
def evaluate_batched(model, episodes: int, epsilon: float,
                     generator: torch.Generator | None = None, move_cap: int = MOVE_CAP,
                     mask_illegal: bool = False) -> dict:
    """All episodes in lockstep on the model's device, the protocol of
    the JAX evaluator: illegal reward -1, epsilon-greedy argmax, at most
    ``move_cap + 1`` moves an episode, no auto-reset. ``mask_illegal``
    restricts both the argmax and the exploration to legal moves (for a
    policy trained with ``PPOConfig.mask_illegal``). Draws come from
    ``generator`` (default: seeded 0 on the device). Returns the result
    dict of ``evaluate_model``."""
    model.eval()
    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cfg = EnvConfig(illegal_move_reward=-1.0, auto_reset=False)
    state = batched.reset(generator, episodes, device=dev)
    total_reward = torch.zeros(episodes, dtype=torch.float32, device=dev)
    illegals = torch.zeros(episodes, dtype=torch.int32, device=dev)
    moves = torch.zeros(episodes, dtype=torch.int32, device=dev)
    highest = torch.zeros(episodes, dtype=torch.int32, device=dev)
    active = torch.ones(episodes, dtype=torch.bool, device=dev)
    for t in range(move_cap + 1):
        if t % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        logits = _policy_logits(model, boards_to_model_input(state.board))
        products = batched.move_products(state)
        u = torch.rand((episodes, 5), generator=generator, device=dev).clamp_min(_TINY)
        if mask_illegal:
            logits = torch.where(products[2], logits, -1e9)
            # a uniform legal move: Gumbel max over the legal ones
            rand_act = torch.where(products[2], -torch.log(-torch.log(u[:, 1:])),
                                   -1e9).argmax(-1)
        else:
            rand_act = (u[:, 1] * 4).long().clamp_max(3)
        greedy = logits.argmax(-1)
        action = torch.where(u[:, 0] <= epsilon, rand_act, greedy)
        state, ts = batched.step_with_products(state, action, products, cfg,
                                               generator=generator)
        total_reward += torch.where(active, ts.reward, 0.0)
        illegals += (active & ts.illegal).to(torch.int32)
        moves += active.to(torch.int32)
        highest = torch.where(active, ts.highest, highest)
        active = active & ~ts.terminated

    total_reward, illegals, moves, highest = (
        x.cpu().numpy() for x in (total_reward, illegals, moves, highest))
    scores = [{"total_reward": float(total_reward[i]), "highest": int(highest[i]),
               "moves": int(moves[i]), "illegal_moves": int(illegals[i])}
              for i in range(episodes)]
    return {
        "Average score": float(total_reward.mean()),
        "Max score": float(total_reward.max()),
        "Highest tile": int(highest.max()),
        "Episodes": scores,
    }
