"""PPO actor-learner on the card (counterpart of ``gym2048_tpu/train/ppo.py``).

One :meth:`PPO.train_iteration` is a rollout of ``n_steps`` batched env
steps under the policy (BatchNorm in eval mode), GAE, and ``n_epochs`` of
shuffled minibatch SGD (BatchNorm in train mode), all on the trainer's
device, with SB3's semantics as the JAX module mirrors them: advantages
normalised per minibatch, clipped surrogate, value MSE scaled by
``vf_coef``, entropy bonus, global gradient-norm clipping, Adam with eps
1e-5 and an optional linear learning-rate anneal.

Where the JAX module scans, this one loops in Python over the same steps;
nothing leaves the device until :meth:`PPO.learn` reads an iteration's
metrics. There is no kernel here: the CNN's convolutions and dense layers
are cuDNN's and cuBLAS's, as they are XLA's in JAX, and the env is
``env/batched.py``.

The optimiser is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(schedule, eps=1e-5))``:

* clipping scales every gradient by ``max_norm / norm`` only when the
  global norm is at least ``max_norm`` (torch's ``clip_grad_norm_`` always
  scales, by ``max_norm / (norm + 1e-6)`` clamped to 1); here the scale is
  one factor for all leaves, where optax divides and multiplies each leaf:
  the same up to one rounding;
* Adam is ``torch.optim.Adam(eps=1e-5)``, which computes optax's
  ``mu_hat / (sqrt(nu_hat) + eps)`` up to roundoff
  (``tests/test_torch_ppo.py`` holds SGD steps to JAX's);
* the linear schedule, like ``optax.linear_schedule`` over ``n_updates *
  n_epochs * n_minibatches`` steps, reads the learning rate at the step
  count before incrementing it, in float32.

Randomness: one ``torch.Generator`` in the :class:`TrainState` draws the
model's initial weights, the env's resets and spawns, the actions (Gumbel
max: the same law as ``jax.random.categorical``, another stream) and the
minibatch permutations. A permutation can also be handed to
:meth:`PPO._update_epochs`, which is how the tests replay JAX's.

Data parallel (``PPO(config, mesh=...)``, the CLI's ``--mesh``): the same
function as one process, as JAX's ``shard_train_state`` and ``jit`` give.
Each of the mesh's ``data`` ranks steps its block of ``n_envs / ranks``
envs. The generator is replicated: every rank draws the whole batch's
uniforms (the Gumbel draws, the env's spawns, the sharded shuffle's
``(T, n_envs)``) and keeps its own columns, so the rollout is the
single-process rollout of the same seed. The shuffle must be
``"sharded"``: its env-major flatten keeps each rank's share of a
minibatch a contiguous slice of it. The loss terms are means over the
global minibatch (each rank computes its share; the advantages are
normalised with the global mean and standard deviation), BatchNorm takes
the global minibatch's statistics (``models.resnet.sync_batch_norm``), the
gradients are summed with ``all_reduce`` before the global-norm clip, and
the metrics are reduced. With one rank no collective is issued, and the
path is the single-process one bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from gym2048_tpu_torch.core import rules
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.env.batched import EnvConfig
from gym2048_tpu_torch.models.resnet import (ActorCritic, boards_to_model_input,
                                             sync_batch_norm)
from gym2048_tpu_torch.ops import returns as returns_ops
from gym2048_tpu_torch.parallel import mesh as pmesh
from gym2048_tpu_torch.utils import profiler

_NEG = -1e9
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters; defaults mirror the reference CLI defaults, as
    the JAX ``PPOConfig``'s do. ``shuffle_mode`` is ``"global"`` (a uniform
    shuffle of the flat ``n_steps * n_envs`` buffer, SB3's) or
    ``"sharded"`` (an independent permutation of the time axis per env, then
    minibatches of contiguous time slices x all envs, flattened env-major;
    needs ``batch_size % n_envs == 0``). ``mask_illegal`` masks illegal
    actions in the policy, in the rollout and in the update."""

    total_timesteps: int = 5_000_000
    n_envs: int = 8
    seed: int = 42
    n_steps: int = 2048
    batch_size: int = 256
    n_epochs: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_coef: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    lr: float = 3e-4
    anneal_lr: bool = False
    filters: int = 64
    residual_blocks: int = 4
    illegal_move_reward: float = 0.0
    compute_dtype: torch.dtype = torch.float32
    log2_rewards: bool = False
    reward_scale: float = 1.0
    shuffle_mode: str = "global"
    mask_illegal: bool = False

    @property
    def rollout_size(self) -> int:
        return self.n_envs * self.n_steps

    @property
    def n_minibatches(self) -> int:
        if self.rollout_size % self.batch_size:
            raise ValueError(f"rollout {self.rollout_size} not divisible by batch "
                             f"{self.batch_size}")
        return self.rollout_size // self.batch_size

    @property
    def n_updates(self) -> int:
        # ceil, like SB3's learn(): train until >= total_timesteps
        return max(1, -(-self.total_timesteps // self.rollout_size))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr_fn, eps=1e-5))``
    over ``params`` (see the module docstring). ``count`` is the
    schedule's step count. With a process ``group`` the gradients are first
    summed over its ranks (one ``all_reduce`` of them all)."""

    def __init__(self, params, lr_fn: Callable[[int], float], max_norm: float,
                 group=None):
        self.params = list(params)
        self.lr_fn = lr_fn
        self.max_norm = max_norm
        self.group = group
        self.adam = torch.optim.Adam(self.params, lr=lr_fn(0), eps=1e-5)
        self.count = 0

    def step(self) -> None:
        """Clip the parameters' gradients, take one Adam step at the
        schedule's learning rate, and clear the gradients."""
        grads = [p.grad for p in self.params]
        if self.group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        factor = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        torch._foreach_mul_(grads, factor)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_fn(self.count)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        """Adam's state and the schedule's count (JAX's ``opt_state``)."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule`` in float32: ``init`` at count 0, ``end``
    from ``transition_steps`` on."""
    f32 = np.float32

    def lr(count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), transition_steps)) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return lr


@dataclasses.dataclass
class TrainState:
    """The learner's state: ``model`` holds the parameters and the
    BatchNorm statistics (JAX's ``params`` and ``batch_stats``),
    ``optimizer`` the Adam moments and the schedule's count (JAX's
    ``opt_state``), ``generator`` every random draw (JAX's ``key``);
    ``update_idx`` counts completed iterations."""

    model: ActorCritic
    optimizer: Optimizer
    env_state: batched.EnvState
    generator: torch.Generator
    update_idx: int = 0


@dataclasses.dataclass(frozen=True)
class Transition:
    """One rollout, time-major ``(T, B, ...)``."""

    board: torch.Tensor    # int8 (4, 4): the observation the policy acted on
    action: torch.Tensor   # int32
    logprob: torch.Tensor  # f32
    value: torch.Tensor    # f32
    reward: torch.Tensor   # f32
    done: torch.Tensor     # bool
    score: torch.Tensor    # f32, the game score including this step (before a reset)
    highest: torch.Tensor  # int32
    ep_len: torch.Tensor   # int32, the episode length including this step


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """The update's buffer (time-major) or one minibatch of it (flat)."""

    board: torch.Tensor
    action: torch.Tensor
    logprob: torch.Tensor
    adv: torch.Tensor
    ret: torch.Tensor

    def map(self, fn) -> UpdateBatch:
        return UpdateBatch(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def ppo_loss_terms(logits: torch.Tensor, value: torch.Tensor, action: torch.Tensor,
                   old_logprob: torch.Tensor, adv: torch.Tensor, ret: torch.Tensor,
                   clip_coef: float, group=None, world: int = 1):
    """PPO loss math on raw policy outputs (SB3's semantics): advantages
    normalised per minibatch (population standard deviation), clipped
    surrogate, value MSE, and the entropy of the (possibly ``-1e9``-masked)
    categorical distribution, where ``p log p`` counts 0 below p = 1e-12.
    Returns ``(policy_loss, value_loss, entropy, approx_kl, clip_frac)``.

    With a process ``group`` of ``world`` ranks, each holding an equal share
    of the minibatch, the advantages are normalised with the whole
    minibatch's mean and standard deviation, and each term is this rank's
    share of the whole minibatch's mean (its sum over the ranks is the
    mean): backpropagating each rank's share and summing the gradients over
    the ranks gives the gradient of the mean."""
    log_probs = torch.log_softmax(logits, dim=-1)
    logprob = log_probs.gather(-1, action.long()[:, None])[:, 0]
    ratio = torch.exp(logprob - old_logprob)
    probs = torch.exp(log_probs)
    plogp = torch.where(probs > 1e-12, probs * log_probs, 0.0)

    if group is None:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        mean = torch.mean
    else:
        n = adv.numel() * world

        def total(x):
            t = x.detach().sum()
            dist.all_reduce(t, group=group)
            return t

        adv_mean = total(adv) / n
        adv_std = (total((adv - adv_mean).square()) / n).sqrt()
        adv = (adv - adv_mean) / (adv_std + 1e-8)

        def mean(x):
            return x.sum() / n
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef) * adv
    policy_loss = -mean(torch.minimum(pg1, pg2))

    value_loss = mean((value - ret) ** 2)
    entropy = -mean(plogp.sum(-1))

    approx_kl = mean((ratio - 1.0) - torch.log(ratio))
    clip_frac = mean(((ratio - 1.0).abs() > clip_coef).float())
    return policy_loss, value_loss, entropy, approx_kl, clip_frac


# the update's metrics, in the order _sgd_step stacks them
_AUX = ("loss", "policy_loss", "value_loss", "entropy", "approx_kl", "clip_frac")


class PPO:
    """PPO trainer on ``device``. Construct, then ``state = init_state()``
    and loop ``state, metrics = train_iteration(state)``, or call
    :meth:`learn` for the driver loop. With a ``mesh``, the data-parallel
    learner over its ``data`` axis (see the module docstring): every rank
    constructs it and calls the same methods."""

    def __init__(self, config: PPOConfig, device: str | torch.device = "cuda", mesh=None):
        self.mesh = mesh
        self.world, self.rank = pmesh.data_size(mesh), pmesh.data_rank(mesh)
        if self.world > 1 and (config.shuffle_mode != "sharded"
                               or config.n_envs % self.world):
            raise ValueError(f"data-parallel PPO over {self.world} ranks needs "
                             f"shuffle_mode='sharded' and n_envs divisible by the ranks")
        self.group = mesh.get_group(pmesh.DATA_AXIS) if self.world > 1 else None
        self.n_local = config.n_envs // self.world
        self.cols = slice(self.rank * self.n_local, (self.rank + 1) * self.n_local)
        if config.shuffle_mode not in ("global", "sharded"):
            raise ValueError(f"shuffle_mode must be 'global' or 'sharded', got "
                             f"{config.shuffle_mode!r}")
        if config.shuffle_mode == "sharded" and (
                config.batch_size % config.n_envs
                or config.n_steps % (config.batch_size // config.n_envs)):
            raise ValueError("shuffle_mode='sharded' needs batch_size % n_envs == 0 and "
                             "n_steps % (batch_size // n_envs) == 0")
        self.cfg = config
        self.device = torch.device(device)
        self.env_cfg = EnvConfig(illegal_move_reward=config.illegal_move_reward,
                                 auto_reset=True)
        total_opt_steps = config.n_updates * config.n_epochs * config.n_minibatches
        if config.anneal_lr:
            # SB3 passes progress_remaining (1 -> 0) to the lr lambda
            self.lr_fn = linear_schedule(config.lr, 0.0, total_opt_steps)
        else:
            self.lr_fn = lambda count: config.lr

    # ------------------------------------------------------------------ init
    def make_optimizer(self, model: ActorCritic) -> Optimizer:
        return Optimizer(model.parameters(), self.lr_fn, self.cfg.max_grad_norm, self.group)

    def init_state(self, generator: torch.Generator | None = None) -> TrainState:
        """A fresh state: ``n_envs`` reset envs and flax-initialised
        weights, drawn from ``generator`` (default: seeded ``cfg.seed``);
        with a mesh, this rank's (:func:`~gym2048_tpu_torch.parallel.mesh.
        shard_train_state`)."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        env_state = batched.reset(generator, cfg.n_envs, device=self.device)
        model = ActorCritic(cfg.filters, cfg.residual_blocks, cfg.compute_dtype,
                            self.device, generator)
        state = TrainState(model, self.make_optimizer(model), env_state, generator)
        return pmesh.shard_train_state(state, self.mesh)

    def global_state(self, state: TrainState) -> TrainState:
        """``state`` with the whole env batch, collected from every rank (a
        collective), sharing the rest: the layout a checkpoint holds.
        ``shard_train_state`` of it is ``state`` again."""
        return dataclasses.replace(
            state, env_state=pmesh.gather_env_state(state.env_state, self.mesh))

    def _uniform(self, generator: torch.Generator, shape: tuple[int, ...],
                 axis: int = 0) -> torch.Tensor:
        """``shape`` uniforms from the replicated ``generator``, the whole
        batch's, and this rank's block of them along ``axis``."""
        u = torch.rand(shape, generator=generator, device=self.device)
        return u if self.world == 1 else u.narrow(axis, self.rank * self.n_local, self.n_local)

    # --------------------------------------------------------------- rollout
    def _policy(self, model: ActorCritic, board: torch.Tensor):
        return model(boards_to_model_input(board, self.cfg.compute_dtype))

    @torch.no_grad()
    def _collect_rollout(self, state: TrainState):
        """``n_steps`` env steps under the policy -> ``(Transition (T, B,
        ...), last_value (B,))``; advances ``state.env_state``."""
        cfg, dev, gen = self.cfg, self.device, state.generator
        t_len, b = cfg.n_steps, self.n_local
        model = state.model.eval()
        traj = Transition(
            board=torch.empty((t_len, b, 4, 4), dtype=torch.int8, device=dev),
            action=torch.empty((t_len, b), dtype=torch.int32, device=dev),
            logprob=torch.empty((t_len, b), dtype=torch.float32, device=dev),
            value=torch.empty((t_len, b), dtype=torch.float32, device=dev),
            reward=torch.empty((t_len, b), dtype=torch.float32, device=dev),
            done=torch.empty((t_len, b), dtype=torch.bool, device=dev),
            score=torch.empty((t_len, b), dtype=torch.float32, device=dev),
            highest=torch.empty((t_len, b), dtype=torch.int32, device=dev),
            ep_len=torch.empty((t_len, b), dtype=torch.int32, device=dev),
        )
        env_state = state.env_state
        for t in range(t_len):
            # the env span holds the step's policy span: one of each a step,
            # the env's own work (the moves, the step, the writes) its self time
            with profiler.span("ppo.env"):
                products = batched.move_products(env_state)
                with profiler.span("ppo.policy"):
                    logits, value = self._policy(model, env_state.board)
                    if cfg.mask_illegal:
                        # one move_all serves both the policy mask and the env step
                        logits = torch.where(products[2], logits, _NEG)
                    # Gumbel max over uniforms in [tiny, 1): jax.random.categorical's law
                    u = self._uniform(gen, (cfg.n_envs, 4)).clamp_min(_TINY)
                    action = (logits - torch.log(-torch.log(u))).argmax(-1)
                    logprob = torch.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
                traj.board[t] = env_state.board
                env_state, ts = batched.step_with_products(
                    env_state, action, products, self.env_cfg,
                    u=self._uniform(gen, (cfg.n_envs, 6)))
                traj.action[t] = action
                traj.logprob[t] = logprob
                traj.value[t] = value
                traj.reward[t] = ts.reward
                traj.done[t] = ts.terminated
                traj.score[t] = ts.score
                traj.highest[t] = ts.highest
                traj.ep_len[t] = ts.steps
        with profiler.span("ppo.policy"):
            _, last_value = self._policy(model, env_state.board)
        state.env_state = env_state
        return traj, last_value

    # ---------------------------------------------------------------- update
    def _sgd_step(self, state: TrainState, mb: UpdateBatch) -> torch.Tensor:
        """One SGD step on a minibatch (BatchNorm in train mode) -> the
        ``_AUX`` metrics stacked ``(6,)``, on the device."""
        cfg = self.cfg
        model = state.model.train()
        with profiler.span("ppo.forward"):
            with (sync_batch_norm(self.group, self.world) if self.group is not None
                  else contextlib.nullcontext()):
                logits, value = self._policy(model, mb.board)
            if cfg.mask_illegal:
                _, _, legal = rules.move_all(mb.board)
                logits = torch.where(legal, logits, _NEG)
            policy_loss, value_loss, entropy, approx_kl, clip_frac = ppo_loss_terms(
                logits, value, mb.action, mb.logprob, mb.adv, mb.ret, cfg.clip_coef,
                self.group, self.world)
            loss = policy_loss - cfg.ent_coef * entropy + cfg.vf_coef * value_loss
        with profiler.span("ppo.backward"):
            loss.backward()
        with profiler.span("ppo.optimizer"):
            state.optimizer.step()
        return torch.stack([loss, policy_loss, value_loss, entropy, approx_kl,
                            clip_frac]).detach()

    def _permutation(self, generator: torch.Generator) -> torch.Tensor:
        """One epoch's shuffle: a permutation of the flat buffer
        (``"global"``), or per env column one of the time axis, ``(T, B)``
        (``"sharded"``; with a mesh, this rank's columns of the whole
        batch's)."""
        cfg = self.cfg
        if cfg.shuffle_mode == "sharded":
            return self._uniform(generator, (cfg.n_steps, cfg.n_envs), axis=1).argsort(0)
        return torch.randperm(cfg.rollout_size, generator=generator, device=self.device)

    def _minibatches(self, data: UpdateBatch, perm: torch.Tensor) -> list[UpdateBatch]:
        """The epoch's minibatches of the time-major buffer ``data`` under
        ``perm`` (see :meth:`_permutation`)."""
        cfg = self.cfg
        perm = perm.to(self.device, torch.int64)
        if cfg.shuffle_mode == "sharded":
            rows = cfg.batch_size // cfg.n_envs

            def permute(x):
                ix = perm.reshape(perm.shape + (1,) * (x.ndim - 2))
                return torch.take_along_dim(x, ix, dim=0)

            shuffled = data.map(permute)
            # flatten env-major: flat index = env * rows + t, as the JAX
            # module does to keep each shard's slice contiguous
            return [shuffled.map(lambda x: x[i * rows:(i + 1) * rows].transpose(0, 1)
                                 .reshape((rows * self.n_local,) + x.shape[2:]))
                    for i in range(cfg.n_minibatches)]
        flat = data.map(lambda x: x.reshape((cfg.rollout_size,) + x.shape[2:]))
        return [flat.map(lambda x: x[perm[i * cfg.batch_size:(i + 1) * cfg.batch_size]])
                for i in range(cfg.n_minibatches)]

    def _update_epochs(self, state: TrainState, data: UpdateBatch,
                       perms: list | None = None) -> dict:
        """``n_epochs`` of shuffled minibatch SGD over the ``(T, B)`` buffer;
        ``perms[e]``, when given, is epoch e's shuffle in the layout of
        :meth:`_permutation` (with a mesh, the whole batch's: this rank takes
        its columns). Returns the metrics' means over every step."""
        cfg = self.cfg
        aux = []
        for epoch in range(cfg.n_epochs):
            if perms is None:
                perm = self._permutation(state.generator)
            else:
                perm = torch.as_tensor(np.array(perms[epoch], copy=True))
                if self.world > 1:
                    perm = perm[:, self.cols]
            for mb in self._minibatches(data, perm):
                aux.append(self._sgd_step(state, mb))
        state.model.eval()
        means = pmesh.all_reduce(torch.stack(aux).mean(0), self.mesh)
        return dict(zip(_AUX, means))

    # ------------------------------------------------------------- iteration
    def train_iteration(self, state: TrainState):
        """One PPO iteration: rollout + GAE + epochs of minibatch SGD.
        Returns ``(state, metrics)``, the state updated in place and the
        metrics as device scalars (no host sync)."""
        cfg = self.cfg
        with profiler.span("ppo.iteration", unit=state.update_idx):
            traj, last_value = self._collect_rollout(state)

            train_reward = traj.reward
            if cfg.log2_rewards:
                train_reward = torch.sign(train_reward) * torch.log2(1.0 + train_reward.abs())
            train_reward = train_reward * cfg.reward_scale
            with profiler.span("ppo.gae"):
                adv, ret = returns_ops.gae(train_reward, traj.value, traj.done, last_value,
                                           gamma=cfg.gamma, lam=cfg.gae_lambda)
            data = UpdateBatch(board=traj.board, action=traj.action, logprob=traj.logprob,
                               adv=adv, ret=ret)
            metrics = self._update_epochs(state, data)

            # episode statistics of the rollout (SB3's ep_info buffer)
            done_f = traj.done.float()
            if self.world == 1:
                n_episodes = done_f.sum()
                sums = ((traj.score * done_f).sum(), (traj.ep_len.float() * done_f).sum(),
                        (traj.highest.float() * done_f).sum())
                highest_max, reward_per_step = traj.highest.max().float(), traj.reward.mean()
            else:
                totals = pmesh.all_reduce(torch.stack([
                    done_f.sum(), (traj.score * done_f).sum(), (traj.ep_len.float() * done_f).sum(),
                    (traj.highest.float() * done_f).sum(), traj.reward.sum()]), self.mesh)
                n_episodes, sums = totals[0], totals[1:4]
                reward_per_step = totals[4] / (cfg.n_steps * cfg.n_envs)
                highest_max = pmesh.all_reduce(traj.highest.max().float(), self.mesh, "max")
            safe = n_episodes.clamp_min(1.0)
            metrics.update(
                n_episodes=n_episodes,
                ep_return_mean=sums[0] / safe,
                ep_len_mean=sums[1] / safe,
                highest_tile_mean=sums[2] / safe,
                highest_tile_max=highest_max,
                reward_per_step=reward_per_step,
            )
        state.update_idx += 1
        return state, metrics

    # ----------------------------------------------------------------- learn
    def learn(self, state: TrainState | None = None,
              callback: Callable[..., None] | None = None,
              log_interval: int = 10) -> TrainState:
        """The training loop. ``callback`` is called as ``callback(update,
        metrics)`` or, if it takes a third parameter, ``callback(update,
        metrics, state)``, with the metrics as host floats plus
        ``timesteps`` and the rolling episode statistics; without one, every
        ``log_interval``-th iteration prints a line (on rank 0 alone with a
        mesh; a callback is called on every rank, with the same metrics)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        wants_state = callback is not None and len(
            inspect.signature(callback).parameters) >= 3
        # rolling episode statistics (SB3's ep_info_buffer): a rollout can
        # end no episode, so keep a completion-weighted running view
        rolling = {"ep_return": 0.0, "highest": 0.0, "weight": 0.0}
        for update in range(state.update_idx, cfg.n_updates):
            state, metrics = self.train_iteration(state)
            if callback is not None or (update + 1) % log_interval == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["timesteps"] = (update + 1) * cfg.rollout_size
                n_eps = host["n_episodes"]
                if n_eps > 0:
                    w = rolling["weight"] * 0.5 + n_eps
                    rolling["ep_return"] = (rolling["ep_return"] * rolling["weight"] * 0.5
                                            + host["ep_return_mean"] * n_eps) / w
                    rolling["highest"] = (rolling["highest"] * rolling["weight"] * 0.5
                                          + host["highest_tile_mean"] * n_eps) / w
                    rolling["weight"] = w
                host["ep_return_rolling"] = rolling["ep_return"]
                host["highest_tile_rolling"] = rolling["highest"]
                if callback is None:
                    if self.rank == 0:
                        print(f"update {update + 1}/{cfg.n_updates} steps {host['timesteps']} "
                              f"ep_rew {host['ep_return_mean']:.1f} "
                              f"highest {host['highest_tile_mean']:.0f} "
                              f"kl {host['approx_kl']:.4f}")
                elif wants_state:
                    callback(update + 1, host, state)
                else:
                    callback(update + 1, host)
        return state
