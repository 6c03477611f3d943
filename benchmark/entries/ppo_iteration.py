"""Entry ``ppo_iteration``: one ``PPO.train_iteration`` of the actor-critic
(rollout, GAE and the epochs of minibatch SGD), read by its loss on the
host as ``PPO.learn`` reads an iteration.

Set-up builds the trainer from the configuration and the traffic; the
benchmark draws the weights (``reference/actor_critic.make_weights``) and
the first boards from ``--seed`` and loads them into the program's model
and env state, then reseeds the program's generator, so that both sides
start from the same inputs and draw the same uniforms. The first
``check_units`` iterations run through :meth:`Entry.unit`, keeping each
rollout (``PPO._collect_rollout``'s result), the loss of each SGD step of
the first epoch (``PPO._sgd_step``'s), the first step's gradients as the
optimiser gets them, and the change of every parameter and BatchNorm
statistic after the last.

The check replays each rollout with the plain rules from the same uniforms
and the program's actions (``env_mismatches``: boards, rewards or ends that
differ), reads the first rollout against the plain network in float32 with
TF32 off (``action_gap``, the widest amount by which the program's sampled
action lies below the best under the same Gumbel noise; ``value_gap``, the
largest value error over the largest value), and runs the plain update on
each of the program's rollouts (``loss_gap``, the largest relative gap of
an SGD step's loss over the first epoch; ``grad_gap``, the worst leaf's gap
of norms of the first gradient; ``change_gap``, the same for the
change after the last iteration, leaving out parameters whose first
gradient in the reference is under a thousandth of the median leaf's).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.entries.base import Entry as Base
from benchmark.entries.base import leaf_gap, norm64
from benchmark.harness import derive_seed

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@contextlib.contextmanager
def reference_precision():
    """Float32 with TF32 off for the plain reference (cuDNN may pick its
    fastest float32 algorithms); torch's settings restored after."""
    b = torch.backends
    saved = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.benchmark = True
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved


class Entry(Base):
    rate_metric = "ppo_steps_per_s"
    rate_unit = "steps/s"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from gym2048_tpu_torch.train import ppo

        self.ppo = ppo
        self.hp = {**self.traffic, "filters": self.config["filters"],
                   "residual_blocks": self.config["residual_blocks"]}
        self.cfg = self._program_config(self.traffic["compute_dtype"])
        self.steps_per_unit = self.cfg.n_steps
        self.trainer = self.state = None

    def _program_config(self, dtype: str):
        t, c = self.traffic, self.config
        return self.ppo.PPOConfig(
            total_timesteps=10 ** 15, n_envs=t["n_envs"], seed=0, n_steps=t["n_steps"],
            batch_size=t["batch_size"], n_epochs=t["n_epochs"], gamma=t["gamma"],
            gae_lambda=t["gae_lambda"], clip_coef=t["clip_coef"], vf_coef=t["vf_coef"],
            ent_coef=t["ent_coef"], max_grad_norm=t["max_grad_norm"], lr=t["lr"],
            anneal_lr=False, filters=c["filters"], residual_blocks=c["residual_blocks"],
            compute_dtype=DTYPES[dtype], reward_scale=t["reward_scale"],
            shuffle_mode=t["shuffle_mode"])

    # ---------------------------------------------------------------- inputs
    def weights(self):
        from benchmark.reference import actor_critic as ac

        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "weights"))
        return ac.make_weights(self.config["filters"], self.config["residual_blocks"], gen)

    def first_boards(self):
        from benchmark.reference import rules

        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "boards"))
        return rules.fresh_boards(torch.rand((self.traffic["n_envs"], 4), generator=gen,
                                             device=self.device))

    def rollout_seed(self) -> int:
        return derive_seed(self.seed, "rollout")

    # ---------------------------------------------------------------- program
    def _leaves(self, model) -> dict[str, torch.Tensor]:
        out = {k: v.detach() for k, v in model.named_parameters()}
        out.update((k, v) for k, v in model.named_buffers() if "running" in k)
        return out

    def _start_program(self, dtype: str):
        from gym2048_tpu_torch.env import batched

        cfg = self._program_config(dtype)
        self.trainer = self.ppo.PPO(cfg, device=self.device)
        self.state = self.trainer.init_state(torch.Generator(device=self.device).manual_seed(0))
        params, stats = self.weights()
        leaves = self._leaves(self.state.model)
        with torch.no_grad():
            for k, v in {**params, **stats}.items():
                leaves[k].copy_(v)
        n = cfg.n_envs
        self.state.env_state = batched.EnvState(
            board=self.first_boards(), score=torch.zeros(n, device=self.device),
            done=torch.zeros(n, dtype=torch.bool, device=self.device),
            step_count=torch.zeros(n, dtype=torch.int32, device=self.device))
        self.state.generator.manual_seed(self.rollout_seed())
        self.initial = {k: v.clone() for k, v in leaves.items()}

    def _capture_units(self) -> dict:
        """The first ``check_units`` iterations through :meth:`unit`, kept."""
        rollouts, losses, grads = [], [], {}
        collect, sgd_step = self.trainer._collect_rollout, self.trainer._sgd_step
        epoch = self.cfg.n_minibatches
        opt, step = self.state.optimizer, self.state.optimizer.step
        names = [k for k, _ in self.state.model.named_parameters()]

        def keep_rollout(state):
            out = collect(state)
            rollouts.append(out)
            return out

        def keep_losses(state, mb):
            aux = sgd_step(state, mb)
            if len(losses) < epoch:
                losses.append(aux[0])
            return aux

        def keep_grads():
            if not grads:
                grads.update((k, norm64(p.grad)) for k, p in zip(names, opt.params))
            step()

        self.trainer._collect_rollout, self.trainer._sgd_step = keep_rollout, keep_losses
        opt.step = keep_grads
        iters = []
        try:
            for _ in range(self.traffic["check_units"]):
                self.unit()
                traj, _ = rollouts[-1]
                iters.append({"board": traj.board, "action": traj.action, "reward": traj.reward,
                              "done": traj.done, "value": traj.value,
                              "next_board": self.state.env_state.board})
        finally:
            del self.trainer._collect_rollout, self.trainer._sgd_step, opt.step
        leaves = self._leaves(self.state.model)
        change = {k: norm64(leaves[k] - self.initial[k]) for k in leaves}
        return {"iters": iters, "losses": [float(x) for x in losses], "first_grads": grads,
                "change": change}

    def setup(self):
        self._start_program(self.traffic["compute_dtype"])
        self.capture = self._capture_units()

    def unit(self) -> float:
        self.state, m = self.trainer.train_iteration(self.state)
        self.last_loss = float(m["loss"])
        return float(self.cfg.rollout_size)

    def release(self):
        self.trainer = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def control(self):
        """The control in the program's place: the program's own path in
        ``control`` precision where the traffic names one it has
        (``"program:bf16"``), else the plain learner in that precision."""
        kind, _, precision = self.traffic["control"].partition(":")
        if kind == "program":
            self._start_program(precision)
            self.capture = self._capture_units()
            self.release()
            return
        from benchmark.reference import ppo as ref

        params, stats = self.weights()
        gen = torch.Generator(device=self.device).manual_seed(self.rollout_seed())
        learner = ref.Learner(params, stats, self.hp, gen, precision)
        n = self.traffic["n_envs"]
        env = (self.first_boards(), torch.zeros(n, device=self.device),
               torch.zeros(n, dtype=torch.int64, device=self.device))
        iters = []
        with reference_precision():
            for _ in range(self.traffic["check_units"]):
                traj, env = learner.rollout(*env)
                _, value = learner.evaluate(traj["board"].reshape(-1, 4, 4))
                learner.update(traj["board"], traj["action"], traj["reward"], traj["done"],
                               env[0])
                iters.append({**traj, "value": value.reshape(traj["action"].shape),
                              "next_board": env[0]})
        leaves = learner.leaves()
        initial = {**params, **stats}
        self.capture = {"iters": iters, "losses": learner.losses[:self.cfg.n_minibatches],
                        "first_grads": learner.first_grads,
                        "change": {k: norm64(leaves[k] - initial[k]) for k in leaves}}

    def check(self):
        from benchmark.reference import ppo as ref
        from benchmark.reference import rules

        cap = self.capture
        params, stats = self.weights()
        gen = torch.Generator(device=self.device).manual_seed(self.rollout_seed())
        n = self.traffic["n_envs"]
        zeros_f = torch.zeros(n, device=self.device)
        zeros_i = torch.zeros(n, dtype=torch.int64, device=self.device)
        env_bad = torch.zeros((), dtype=torch.int64, device=self.device)
        action_gap = torch.zeros((), device=self.device)
        value_gap = 0.0
        with reference_precision():
            learner = ref.Learner(params, stats, self.hp, gen, "f32")
            for k, it in enumerate(cap["iters"]):
                boards, actions = it["board"], it["action"].to(torch.int64)
                steps = boards.shape[0]
                if k == 0:
                    logits, value = learner.evaluate(boards.reshape(-1, 4, 4))
                    logits, value = logits.reshape(steps, n, 4), value.reshape(steps, n)
                    value_gap = float((it["value"] - value).abs().max()
                                      / value.abs().max().clamp(min=1e-30))
                for t in range(steps):
                    u_act, u_env = learner.rollout_draws()
                    if k == 0:
                        noisy = logits[t] - torch.log(-torch.log(u_act.clamp(min=ref.TINY)))
                        gap = noisy.amax(-1) - noisy.gather(1, actions[t][:, None])[:, 0]
                        action_gap = torch.maximum(action_gap, gap.max())
                    nxt, _, _, reward, ended, *_ = rules.env_step(
                        boards[t], zeros_f, zeros_i, actions[t], u_env, auto_reset=True)
                    want = boards[t + 1] if t + 1 < steps else it["next_board"]
                    env_bad += ((nxt != want).reshape(n, 16).any(-1).sum()
                                + (reward != it["reward"][t]).sum()
                                + (ended != it["done"][t]).sum())
                learner.update(boards, actions, it["reward"], it["done"], it["next_board"])
            leaves = learner.leaves()
        initial = {**params, **stats}
        ref_change = {k: norm64(leaves[k] - initial[k]) for k in leaves}
        grads = learner.first_grads
        g = sorted(grads.values())
        floor = 1e-3 * g[len(g) // 2]
        kept = [k for k in ref_change if k not in grads or grads[k] >= floor]
        return self.numbers({
            "env_mismatches": float(env_bad),
            "action_gap": float(action_gap),
            "value_gap": value_gap,
            "loss_gap": max(abs(p - r) / max(abs(r), 1e-6) for p, r in
                            zip(cap["losses"], learner.losses[:self.cfg.n_minibatches])),
            "grad_gap": leaf_gap(cap["first_grads"], grads),
            "change_gap": leaf_gap({k: cap["change"][k] for k in kept},
                                   {k: ref_change[k] for k in kept}),
        })
