"""PPO iterations of the actor-critic, written plainly (SB3's semantics).

An iteration: a rollout of ``n_steps`` steps of ``n_envs`` auto-resetting
games under the policy (BatchNorm in evaluation), each action drawn by
Gumbel-max from uniforms in [tiny, 1); GAE (gamma, lambda) from the
critic's values, bootstrapped by the value of the boards after the last
step; then ``n_epochs`` epochs of minibatch SGD (BatchNorm in training):
advantages normalised per minibatch by the population standard deviation
(+1e-8), the clipped surrogate, the value's squared error times
``vf_coef``, minus ``ent_coef`` times the entropy (``p log p`` counted 0
below p = 1e-12); the gradients scaled by ``max_norm / norm`` when their
global norm reaches ``max_norm``; Adam (0.9, 0.999, eps 1e-5) at ``lr``.

Shuffles: ``"global"`` takes ``randperm`` of the flat time-major buffer,
minibatch i its slice i; ``"sharded"`` draws ``(n_steps, n_envs)`` uniforms,
sorts each env's column (``argsort`` over time), and minibatch i is rows
``i * b .. (i + 1) * b`` (``b = batch / n_envs``) of every column, env-major.

The uniforms come from a ``torch.Generator`` in the order of the learner
under test: per rollout step ``(n_envs, 4)`` for the actions, then
``(n_envs, 6)`` for the env; per epoch the shuffle's draw.

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference import actor_critic as ac
from benchmark.reference import rules

TINY = torch.finfo(torch.float32).tiny


def policy_eval(params, stats, boards, blocks, precision, block_rows: int = 16384):
    """Evaluation-mode ``(logits, value)`` of many boards, in blocks."""
    outs = [ac.forward(params, stats, boards[i:i + block_rows], blocks, False, precision)
            for i in range(0, boards.shape[0], block_rows)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def sample(logits, u):
    """Gumbel-max actions from the uniforms ``u``, and their log-probabilities."""
    noise = -torch.log(-torch.log(u.clamp(min=TINY)))
    action = (logits + noise).argmax(-1)
    logp = torch.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
    return action, logp


def gae(rewards, values, dones, last_value, gamma, lam):
    adv = torch.empty_like(rewards)
    nxt_v, nxt_a = last_value, torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        keep = 1.0 - dones[t].float()
        delta = rewards[t] + gamma * nxt_v * keep - values[t]
        nxt_a = delta + gamma * lam * keep * nxt_a
        adv[t] = nxt_a
        nxt_v = values[t]
    return adv, adv + values


def loss_terms(logits, value, action, old_logp, adv, ret, clip):
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, action[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    p = torch.exp(logp_all)
    entropy = -torch.where(p > 1e-12, p * logp_all, 0.0).sum(-1).mean()
    return -surrogate.mean(), ((value - ret) ** 2).mean(), entropy


class Learner:
    """The plain learner from ``(params, stats)`` (see
    :func:`~benchmark.reference.actor_critic.make_weights`), a ``traffic``
    (PPO's hyperparameters) and a generator; ``precision`` is the layers'
    (:mod:`~benchmark.reference.actor_critic`)."""

    def __init__(self, params, stats, traffic: dict, generator, precision: str = "f32"):
        self.t = traffic
        self.blocks = traffic["residual_blocks"]
        self.params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.gen = generator
        self.precision = precision
        self.first_grads = None
        self.losses: list[float] = []  # every SGD step's loss, in order

    def evaluate(self, boards):
        with torch.no_grad():
            return policy_eval(self.params, self.stats, boards, self.blocks, self.precision)

    def rollout_draws(self):
        """One rollout step's uniforms: ``(actions (n_envs, 4), env (n_envs, 6))``."""
        n, dev = self.t["n_envs"], self.gen.device
        return (torch.rand((n, 4), generator=self.gen, device=dev),
                torch.rand((n, 6), generator=self.gen, device=dev))

    def rollout(self, board, score, steps):
        """The plain learner's own rollout from an env state: ``(boards,
        actions, rewards, dones, next state)``, time-major."""
        out = {"board": [], "action": [], "reward": [], "done": []}
        for _ in range(self.t["n_steps"]):
            u_act, u_env = self.rollout_draws()
            logits, _ = self.evaluate(board)
            action, _ = sample(logits, u_act)
            out["board"].append(board)
            out["action"].append(action)
            board, score, steps, reward, ended, *_ = rules.env_step(
                board, score, steps, action, u_env, auto_reset=True)
            out["reward"].append(reward)
            out["done"].append(ended)
        return {k: torch.stack(v) for k, v in out.items()}, (board, score, steps)

    def _step(self, board, action, old_logp, adv, ret):
        t = self.t
        logits, value = ac.forward(self.params, self.stats, board, self.blocks, True,
                                   self.precision)
        pg, vf, ent = loss_terms(logits, value, action, old_logp, adv, ret, t["clip_coef"])
        loss = pg - t["ent_coef"] * ent + t["vf_coef"] * vf
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        if self.first_grads is None:
            self.first_grads = {k: float(torch.linalg.vector_norm(g, dtype=torch.float64))
                                for k, g in zip(names, grads)}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        factor = torch.where(norm < t["max_grad_norm"], 1.0, t["max_grad_norm"] / norm)
        self.count += 1
        b1, b2, eps, lr = 0.9, 0.999, 1e-5, t["lr"]
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = g * factor
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                m_hat = self.m[k] / (1 - b1 ** self.count)
                v_hat = self.v[k] / (1 - b2 ** self.count)
                self.params[k] -= lr * m_hat / (v_hat.sqrt() + eps)
        return loss.detach()

    def _minibatches(self, data: dict):
        t = self.t
        n, steps, batch = t["n_envs"], t["n_steps"], t["batch_size"]
        dev = self.gen.device
        if t["shuffle_mode"] == "sharded":
            perm = torch.rand((steps, n), generator=self.gen, device=dev).argsort(0)
            rows = batch // n
            shuffled = {k: torch.take_along_dim(v, perm.reshape(perm.shape + (1,) * (v.ndim - 2)),
                                                0) for k, v in data.items()}
            for i in range(steps // rows):
                yield {k: v[i * rows:(i + 1) * rows].transpose(0, 1).reshape(
                    (rows * n,) + v.shape[2:]) for k, v in shuffled.items()}
        else:
            perm = torch.randperm(steps * n, generator=self.gen, device=dev)
            flat = {k: v.reshape((steps * n,) + v.shape[2:]) for k, v in data.items()}
            for i in range(steps * n // batch):
                sel = perm[i * batch:(i + 1) * batch]
                yield {k: v[sel] for k, v in flat.items()}

    def update(self, board, action, reward, done, last_board) -> None:
        """One iteration's update from a rollout (time-major ``(T, B, ...)``)
        and the boards after its last step; its SGD steps' losses join
        ``self.losses``."""
        t = self.t
        steps, n = action.shape
        logits, values = self.evaluate(board.reshape(steps * n, 4, 4))
        logp = torch.log_softmax(logits, -1).gather(
            -1, action.reshape(-1, 1).to(torch.int64))[:, 0].reshape(steps, n)
        _, last_value = self.evaluate(last_board)
        adv, ret = gae(reward * t["reward_scale"], values.reshape(steps, n), done, last_value,
                       t["gamma"], t["gae_lambda"])
        data = {"board": board, "action": action.to(torch.int64), "logp": logp, "adv": adv,
                "ret": ret}
        losses = []
        for _ in range(t["n_epochs"]):
            for mb in self._minibatches(data):
                losses.append(self._step(mb["board"], mb["action"], mb["logp"], mb["adv"],
                                         mb["ret"]))
        self.losses += torch.stack(losses).tolist()

    def leaves(self) -> dict[str, torch.Tensor]:
        return {**{k: v.detach() for k, v in self.params.items()}, **self.stats}
