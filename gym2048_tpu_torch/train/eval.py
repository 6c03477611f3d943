"""Evaluation harness, the batched half (counterpart of
``gym2048_tpu/train/eval.py``).

Protocol (the reference's): episodes on fresh envs with illegal-move reward
-1, epsilon-greedy over the policy's argmax, a 2000-move cap; the result
reports the average and max total reward and the highest tile, and
:func:`report_evaluation_results` writes ``scores_<label>.csv``.

* :func:`make_predict_fn` and :func:`choose_action`: the one-observation
  policy, with Python's ``random`` in the reference's call order;
* :func:`evaluate_batched`: all episodes at once on the model's device,
  with its random draws from a ``torch.Generator`` (the same laws as the
  JAX evaluator's keys, another stream).

``evaluate_episode`` and ``evaluate_model`` (the host loop over the
Gymnasium adapter, bit-exact to the reference's NumPy streams) are not
ported yet: they wait for the adapter and ``rules_np``.
"""

from __future__ import annotations

import csv
import random
from typing import Callable

import numpy as np
import torch

from gym2048_tpu_torch.env import batched
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
    """One-observation probability function of ``model`` (eval mode): the
    ``(16, 4, 4)`` env observation -> probabilities ``(4,)`` as numpy."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict(observation: np.ndarray) -> np.ndarray:
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


HOST_EVAL_NOT_PORTED = (
    "evaluate_episode and evaluate_model (the host loop over the Gymnasium adapter) are "
    "not ported yet: ROADMAP.md Queue 1 item 9; use evaluate_batched")


def evaluate_episode(*args, **kwargs):
    raise NotImplementedError(HOST_EVAL_NOT_PORTED)


def evaluate_model(*args, **kwargs):
    raise NotImplementedError(HOST_EVAL_NOT_PORTED)


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
