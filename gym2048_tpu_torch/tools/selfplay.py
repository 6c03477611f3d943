"""Self-play training-data generator (counterpart of
``gym2048_tpu/tools/selfplay.py``).

Rolls out the batched env on the device with a policy (random-legal, or a
trained model) and exports the transitions in the standard 35-column CSV
schema. The rollout stays on the device; the host then flattens it to
per-env order and drops illegal moves (:func:`postprocess`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

_TINY = torch.finfo(torch.float32).tiny


def postprocess(boards, actions, rewards, nexts, dones, illegal):
    """Time-major ``(T, B, ...)`` rollout arrays -> :class:`TrainingData`.

    Rows are flattened to per-env order (env ``b``'s ``T`` steps in game
    order, then env ``b + 1``'s), illegal rows are dropped (board unchanged:
    no training signal; the reference collector skips them too), and a
    dropped row's ``done`` moves back onto the previous kept row of the same
    env and episode, as an illegal move ends the episode. ``nexts`` are the
    boards after each transition, before any reset.
    """
    from gym2048_tpu_torch.data import TrainingData

    steps = np.asarray(boards).shape[0]

    def flat(x):
        x = np.asarray(x)
        return np.swapaxes(x, 0, 1).reshape((-1,) + x.shape[2:])

    boards, actions, rewards, nexts, dones, illegal = map(
        flat, (boards, actions, rewards, nexts, dones, illegal))
    dones = dones.copy()
    keep = ~illegal
    dropped_done = illegal & dones
    env_of = np.arange(len(keep)) // steps
    for i in np.nonzero(dropped_done)[0]:
        j = i - 1
        # walk past other dropped rows, staying inside this env's slice
        # and this episode (an earlier done ends the search)
        while j >= 0 and env_of[j] == env_of[i] and not keep[j] and not dones[j]:
            j -= 1
        if j >= 0 and env_of[j] == env_of[i] and keep[j] and not dones[j]:
            dones[j] = True
    return TrainingData.from_rollout(boards[keep], actions[keep], rewards[keep],
                                     nexts[keep], dones[keep])


@torch.no_grad()
def rollout(n_transitions: int, policy: str = "random", model_path: str | None = None,
            batch: int = 256, seed: int = 0, epsilon: float = 0.0,
            device: str | torch.device = "cuda"):
    """``ceil(n_transitions / batch)`` lockstep steps of ``batch`` auto-
    resetting envs on ``device``, every draw from one ``torch.Generator``
    seeded ``seed``. ``policy`` ``"random"`` takes a uniform legal action
    (Gumbel max over the legal ones); ``"model"`` the argmax of the saved
    model's logits, and with probability ``epsilon`` a uniform action of
    the four. Returns the time-major host arrays ``(boards, actions,
    rewards, final boards, terminated, illegal)`` of :func:`postprocess`."""
    from gym2048_tpu_torch.env import batched
    from gym2048_tpu_torch.env.batched import EnvConfig
    from gym2048_tpu_torch.models.resnet import boards_to_model_input
    from gym2048_tpu_torch.train.eval import _policy_logits

    dev = torch.device(device)
    model = None
    if policy == "model":
        from gym2048_tpu_torch import interop
        from gym2048_tpu_torch.utils.checkpoint import load_model

        variables, _ = load_model(model_path)
        model = interop.resnet_from_variables(variables, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = EnvConfig(auto_reset=True)
    steps = -(-n_transitions // batch)
    state = batched.reset(gen, batch, device=dev)
    out = {k: [] for k in ("board", "action", "reward", "next", "done", "illegal")}
    for _ in range(steps):
        products = batched.move_products(state)
        u = torch.rand((batch, 5), generator=gen, device=dev).clamp_min(_TINY)
        if model is None:
            gumbel = -torch.log(-torch.log(u[:, 1:]))
            action = torch.where(products[2], gumbel, -1e9).argmax(-1)
        else:
            greedy = _policy_logits(model, boards_to_model_input(state.board)).argmax(-1)
            explore = (u[:, 1] * 4).long().clamp_max(3)
            action = torch.where(u[:, 0] <= epsilon, explore, greedy)
        out["board"].append(state.board)
        state, ts = batched.step_with_products(state, action, products, cfg, generator=gen)
        out["action"].append(action.to(torch.int32))
        out["reward"].append(ts.reward)
        # the board after the transition, before a reset: ts.board would put
        # the next episode's fresh board into next_x
        out["next"].append(ts.final_board)
        out["done"].append(ts.terminated)
        out["illegal"].append(ts.illegal)
    return tuple(torch.stack(out[k]).cpu().numpy() for k in out)


def generate(n_transitions: int, policy: str = "random", model_path: str | None = None,
             batch: int = 256, seed: int = 0, epsilon: float = 0.0,
             device: str | torch.device = "cuda"):
    """Collect about ``n_transitions`` (board, action, reward, next, done)
    tuples as a :class:`TrainingData`: :func:`rollout`, then
    :func:`postprocess`. Only legal moves are recorded (like the human
    collector, which skips illegal entries — gather_training_data.py:194-198)."""
    return postprocess(*rollout(n_transitions, policy, model_path, batch, seed, epsilon,
                                device))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--output", "-o", default="selfplay.csv")
    p.add_argument("--transitions", "-n", type=int, default=10000)
    p.add_argument("--policy", choices=["random", "model"], default="random")
    p.add_argument("--model", default=None, help="Model for --policy model")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epsilon", type=float, default=0.0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    td = generate(args.transitions, args.policy, args.model, args.batch, args.seed,
                  args.epsilon, args.device)
    td.export_csv(args.output)
    print(f"{td.size()} transitions written to {args.output} "
          f"(highest tile {td.get_highest_tile()})")


if __name__ == "__main__":
    main()
