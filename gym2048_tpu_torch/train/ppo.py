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
``env/batched.py``. On a CUDA device with one rank each rollout step is
one CUDA graph replay (:class:`_RolloutGraph`): the policy's forward, the
mask, the Gumbel-max sampling, the env step and the trajectory's writes
launched at once, on static buffers that the step's uniforms are drawn
into; and each SGD step is one (:class:`_SgdGraph`): the forward, the loss,
the backward, the clip and Adam, on static buffers that the step's
minibatch is copied into.

The optimiser is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(schedule, eps=1e-5))``:

* clipping scales every gradient by ``max_norm / norm`` only when the
  global norm is at least ``max_norm`` (torch's ``clip_grad_norm_`` always
  scales, by ``max_norm / (norm + 1e-6)`` clamped to 1); here the scale is
  one factor for all leaves, where optax divides and multiplies each leaf:
  the same up to one rounding;
* Adam is torch's single-tensor ``Adam(eps=1e-5)`` written in foreach ops
  (:meth:`Optimizer.apply`) on a ``torch.optim.Adam``'s state, whose
  ``state_dict`` is the checkpoint's: the same numbers as ``Adam.step`` bit
  for bit on the CPU, and on the card in every path, graphed, eager or data
  parallel. Its two step-dependent scalars are computed on the host in
  float64 as torch computes them (:meth:`Optimizer.advance`) and read on the
  device, so a CUDA graph can hold the update. It computes optax's
  ``mu_hat / (sqrt(nu_hat) + eps)`` up to roundoff (``tests/test_torch_ppo.py``
  holds SGD steps to JAX's);
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
from gym2048_tpu_torch.utils import graphs, profiler

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
    summed over its ranks (one ``all_reduce`` of them all). A step is
    :meth:`advance` on the host, then :meth:`apply` on the device, which a
    CUDA graph can hold; :attr:`scalars` carries the step's two Adam
    scalars from one to the other."""

    def __init__(self, params, lr_fn: Callable[[int], float], max_norm: float,
                 group=None):
        self.params = list(params)
        self.lr_fn = lr_fn
        self.max_norm = max_norm
        self.group = group
        # Adam's hyper-parameters and state in torch's layout; the update is apply's
        self.adam = torch.optim.Adam(self.params, lr=lr_fn(0), eps=1e-5)
        self._init_state()
        dev = self.params[0].device
        self.scalars = (torch.zeros((), device=dev), torch.zeros((), device=dev))
        self.count = 0

    def _init_state(self) -> None:
        """Adam's state where a parameter has none, as ``Adam.step`` makes it
        at its first step: both moments zero, the step count a float32
        scalar on the CPU."""
        for p in self.params:
            state = self.adam.state[p]
            if not state:
                state["step"] = torch.tensor(0.0)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def step(self) -> None:
        """Clip the parameters' gradients, take one Adam step at the
        schedule's learning rate, and clear the gradients."""
        if self.group is not None:
            grads = [p.grad for p in self.params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        self.advance()
        self.apply()

    def advance(self) -> None:
        """The host's part of a step: the schedule's learning rate into
        Adam's group, Adam's step counts and ``count`` advanced, and into
        :attr:`scalars` the update's ``-lr / (1 - beta1^t)`` and ``sqrt(1 -
        beta2^t)``, computed in float64 as ``Adam.step`` computes them."""
        (group,) = self.adam.param_groups
        group["lr"] = lr = self.lr_fn(self.count)
        steps = [self.adam.state[p]["step"] for p in self.params]
        torch._foreach_add_(steps, 1.0)
        t = float(steps[0])
        beta1, beta2 = group["betas"]
        self.scalars[0].fill_(-(lr / (1 - beta1 ** t)))
        self.scalars[1].fill_((1 - beta2 ** t) ** 0.5)
        self.count += 1

    @torch.no_grad()
    def apply(self) -> None:
        """The device's part of a step: the global-norm clip of the
        parameters' gradients, Adam's update of its moments and of the
        parameters in foreach ops with :meth:`advance`'s scalars, in the
        order of torch's single-tensor Adam, and the gradients cleared."""
        grads = [p.grad for p in self.params]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        factor = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        torch._foreach_mul_(grads, factor)
        (group,) = self.adam.param_groups
        beta1, beta2 = group["betas"]
        states = [self.adam.state[p] for p in self.params]
        exp_avgs = [s["exp_avg"] for s in states]
        exp_avg_sqs = [s["exp_avg_sq"] for s in states]
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, self.scalars[1])
        torch._foreach_add_(denom, group["eps"])
        update = torch._foreach_mul(exp_avgs, self.scalars[0])
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update)
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """Adam's state and the schedule's count (JAX's ``opt_state``)."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s, also one saved before Adam's state
        existed (it is then made as at construction)."""
        self.adam.load_state_dict(state["adam"])
        self._init_state()
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

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    @classmethod
    def empty(cls, t_len: int, b: int, device: torch.device) -> Transition:
        """An uninitialised ``(t_len, b, ...)`` rollout on ``device``."""
        def new(dtype, *shape):
            return torch.empty((t_len, b, *shape), dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        return cls(board=new(torch.int8, 4, 4), action=new(i32), logprob=new(f32),
                   value=new(f32), reward=new(f32), done=new(torch.bool), score=new(f32),
                   highest=new(i32), ep_len=new(i32))


def _env_tensors(env_state: batched.EnvState) -> tuple[torch.Tensor, ...]:
    return tuple(getattr(env_state, f.name) for f in dataclasses.fields(env_state))


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """The update's buffer (time-major) or one minibatch of it (flat)."""

    board: torch.Tensor
    action: torch.Tensor
    logprob: torch.Tensor
    adv: torch.Tensor
    ret: torch.Tensor

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def map(self, fn) -> UpdateBatch:
        return UpdateBatch(*map(fn, self.tensors()))


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


class _SgdGraph:
    """SGD steps of :meth:`PPO._sgd_step` on static buffers: :attr:`inputs`,
    the minibatch that a step copies in, and :attr:`aux`, the step's
    ``_AUX`` metrics. A step is the eager step's arithmetic: the forward in
    train mode (BatchNorm's running statistics updated), the legal mask, the
    loss terms, the backward into gradients that start from none, then
    :meth:`Optimizer.advance` on the host and :meth:`Optimizer.apply`. The
    first :data:`graphs.WARMUP` steps run the eager step instead, as real
    steps of their minibatches; on a CUDA device the next step is captured
    once as a CUDA graph, and it and every later step is a replay
    (:class:`graphs.GraphedStep`); elsewhere a replay calls the same code. A
    step returns a copy of :attr:`aux`, which later steps leave as it is."""

    def __init__(self, key: tuple, state: TrainState, mb: UpdateBatch):
        self.key, self.model, self.optimizer = key, state.model, state.optimizer
        self.adam_state = state.optimizer.adam.state  # held: its id is in the key
        dev = mb.board.device
        self.inputs = mb.map(torch.empty_like)
        self.aux = torch.zeros(len(_AUX), device=dev)
        self.graphed = graphs.GraphedStep(self._run, "ppo.sgd_replays", dev)

    @staticmethod
    def key_of(trainer: PPO, state: TrainState, mb: UpdateBatch) -> tuple:
        """What a capture fixes: the minibatch's shapes, dtypes and device,
        the loss's settings and the clip, the model's and the optimiser's
        objects and the memory of the parameters, buffers and Adam's state,
        and torch's settings that choose kernels."""
        cfg, model, opt = trainer.cfg, state.model, state.optimizer
        adam = opt.adam.state
        return ((cfg.compute_dtype, cfg.mask_illegal, cfg.clip_coef, cfg.ent_coef, cfg.vf_coef,
                 opt.max_norm),
                tuple((x.shape, x.dtype, x.device) for x in mb.tensors()),
                id(model), id(opt), id(adam),
                tuple(t.data_ptr() for t in model.parameters()),
                tuple(t.data_ptr() for t in model.buffers()),
                tuple(s[k].data_ptr() for s in adam.values() for k in ("exp_avg", "exp_avg_sq")),
                graphs.kernel_flags())

    def _run(self, trainer: PPO) -> None:
        """One step on the buffers (what the graph holds)."""
        loss, terms = trainer._loss(self.model.train(), self.inputs)
        loss.backward()
        self.optimizer.apply()
        self.aux.copy_(torch.stack([loss, *terms]).detach())

    def load(self, mb: UpdateBatch) -> None:
        """Copy the step's minibatch into :attr:`inputs`."""
        for buf, x in zip(self.inputs.tensors(), mb.tensors()):
            buf.copy_(x)

    def step(self, trainer: PPO, state: TrainState, mb: UpdateBatch) -> torch.Tensor:
        """One SGD step of ``trainer`` on ``mb`` -> its ``_AUX`` metrics ``(6,)``."""
        if self.graphed.warming:
            return self.graphed.eager(trainer._sgd_eager, state, mb)
        with profiler.span("ppo.sgd"):
            self.load(mb)
            self.optimizer.advance()
            self.graphed.replay(trainer)
            return self.aux.clone()


class _RolloutGraph:
    """The rollout of :meth:`PPO._collect_rollout`, a step at a time on
    static buffers: :attr:`env`, the env state that a step reads and writes
    back; :attr:`u_act` and :attr:`u_env`, the whole batch's uniforms of a
    step (each rank reads its block); :attr:`traj`, the whole ``(n_steps,
    n_local, ...)`` trajectory, whose row :attr:`step` (a device index) a
    step writes. A step (:meth:`_run`) is the moves, the policy in eval mode,
    the mask, the Gumbel-max on the action's uniforms, the logprob and the
    env step on the env's. On a CUDA device with one rank it is one CUDA
    graph replay after its warm-ups (:class:`graphs.GraphedStep`); the
    graph reads no generator and no host scalar, so the step's uniforms are
    drawn into the buffers before each replay, in the order and shapes of
    every other step's draws. Elsewhere (the CPU, data parallel) each step
    is a plain call that draws its uniforms itself. A rollout returns copies
    of the trajectory and of the env state, which later rollouts leave as
    they are."""

    def __init__(self, key: tuple, trainer: PPO, state: TrainState):
        dev, cfg, b = trainer.device, trainer.cfg, trainer.n_local
        self.key, self.model = key, state.model
        self.env = batched.EnvState(*map(torch.empty_like, _env_tensors(state.env_state)))
        self.traj = Transition.empty(cfg.n_steps, b, dev)
        self.u_act = torch.empty((cfg.n_envs, 4), device=dev)
        self.u_env = torch.empty((cfg.n_envs, 6), device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        # graphed with one rank only, as the SGD step: data parallel steps
        # eagerly
        self.graphed = graphs.GraphedStep(self._run, "ppo.rollout_replays",
                                          dev if trainer.group is None else None)

    @staticmethod
    def key_of(trainer: PPO, state: TrainState) -> tuple:
        """What a capture fixes: the envs, steps and device, the policy's
        precision and mask, the env's config, the model's object and the
        memory of its parameters and buffers (BatchNorm's running statistics
        are read where the SGD step updates them), and torch's settings
        that choose kernels."""
        cfg, model = trainer.cfg, state.model
        return ((trainer.n_local, cfg.n_envs, cfg.n_steps, trainer.device, cfg.compute_dtype,
                 cfg.mask_illegal, trainer.env_cfg),
                id(model),
                tuple(t.data_ptr() for t in model.parameters()),
                tuple(t.data_ptr() for t in model.buffers()),
                graphs.kernel_flags())

    def draw(self, generator: torch.Generator, u: torch.Tensor) -> None:
        """The whole batch's uniforms into ``u`` (:attr:`u_act` or :attr:`u_env`)."""
        torch.rand(u.shape, generator=generator, out=u)

    def _run(self, trainer: PPO, generator: torch.Generator | None = None) -> None:
        """One step on the buffers (what the graph holds). With
        ``generator`` the step draws its uniforms first, each where the
        eager step of PPO always drew it (the action's in ``ppo.policy``)."""
        cfg, env = trainer.cfg, self.env
        rows = slice(trainer.rank * trainer.n_local, (trainer.rank + 1) * trainer.n_local)
        products = batched.move_products(env)
        with profiler.span("ppo.policy"):
            logits, value = trainer._policy(self.model, env.board)
            if cfg.mask_illegal:
                # one move_all serves both the policy mask and the env step
                logits = torch.where(products[2], logits, _NEG)
            if generator is not None:
                self.draw(generator, self.u_act)
            # Gumbel max over uniforms in [tiny, 1): jax.random.categorical's law
            u = self.u_act[rows].clamp_min(_TINY)
            action = (logits - torch.log(-torch.log(u))).argmax(-1)
            logprob = torch.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
        if generator is not None:
            self.draw(generator, self.u_env)
        new, ts = batched.step_with_products(env, action, products, trainer.env_cfg,
                                             u=self.u_env[rows])
        fields = (env.board, action, logprob, value, ts.reward, ts.terminated, ts.score,
                  ts.highest, ts.steps)
        for buf, x in zip(self.traj.tensors(), fields):
            buf.index_copy_(0, self.step, x.to(buf.dtype)[None])
        for buf, x in zip(_env_tensors(env), _env_tensors(new)):
            buf.copy_(x)
        self.step.add_(1)

    def rollout(self, trainer: PPO, state: TrainState) -> tuple[Transition, batched.EnvState]:
        """``n_steps`` steps from ``state.env_state`` with ``state.generator``'s
        draws -> copies of the trajectory and of the env state after it."""
        gen, graphed = state.generator, self.graphed
        for buf, x in zip(_env_tensors(self.env), _env_tensors(state.env_state)):
            buf.copy_(x)
        self.step.zero_()
        for _ in range(trainer.cfg.n_steps):
            # the env span holds the step: its draws and its replay, or,
            # eagerly, its own work (the draws, the moves, the env step, the
            # writes) around the step's policy span
            with profiler.span("ppo.env"):
                if graphed.captures and not graphed.warming:
                    self.draw(gen, self.u_act)
                    self.draw(gen, self.u_env)
                    graphed.replay(trainer)
                else:
                    graphed.eager(self._run, trainer, gen)
                if graphed.captures:
                    profiler.count("ppo.rollout_steps", 1)
        return (Transition(*(x.clone() for x in self.traj.tensors())),
                batched.EnvState(*(x.clone() for x in _env_tensors(self.env))))


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
        # each SGD step a CUDA graph replay (_SgdGraph): on a CUDA device with
        # one rank, where no collective runs inside the step
        self.graph_sgd = self.device.type == "cuda" and self.group is None
        self._sgd_graph = None
        self._rollout_graph = None  # the _RolloutGraph of _collect_rollout

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
        ...), last_value (B,))``, tensors of their own; advances
        ``state.env_state``. The steps run on a :class:`_RolloutGraph`'s
        buffers (on a CUDA device with one rank one CUDA graph replay a step
        after its warm-ups), built at the first rollout and again when what
        its capture fixes changes (:meth:`_RolloutGraph.key_of`: new shapes,
        settings or model)."""
        model = state.model.eval()
        key = _RolloutGraph.key_of(self, state)
        if self._rollout_graph is None or self._rollout_graph.key != key:
            self._rollout_graph = None  # the old graph and buffers go first
            self._rollout_graph = _RolloutGraph(key, self, state)
        traj, env_state = self._rollout_graph.rollout(self, state)
        with profiler.span("ppo.policy"):
            _, last_value = self._policy(model, env_state.board)
        state.env_state = env_state
        return traj, last_value

    # ---------------------------------------------------------------- update
    def _loss(self, model: ActorCritic, mb: UpdateBatch):
        """The forward of ``mb`` through ``model``, the legal mask and the
        loss terms -> ``(loss, (policy_loss, value_loss, entropy, approx_kl,
        clip_frac))``."""
        cfg = self.cfg
        with (sync_batch_norm(self.group, self.world) if self.group is not None
              else contextlib.nullcontext()):
            logits, value = self._policy(model, mb.board)
        if cfg.mask_illegal:
            _, _, legal = rules.move_all(mb.board)
            logits = torch.where(legal, logits, _NEG)
        terms = ppo_loss_terms(logits, value, mb.action, mb.logprob, mb.adv, mb.ret,
                               cfg.clip_coef, self.group, self.world)
        policy_loss, value_loss, entropy = terms[:3]
        return policy_loss - cfg.ent_coef * entropy + cfg.vf_coef * value_loss, terms

    def _sgd_eager(self, state: TrainState, mb: UpdateBatch) -> torch.Tensor:
        """:meth:`_sgd_step` launched op by op, ``Optimizer.step`` for the
        optimiser."""
        with profiler.span("ppo.forward"):
            loss, terms = self._loss(state.model.train(), mb)
        with profiler.span("ppo.backward"):
            loss.backward()
        with profiler.span("ppo.optimizer"):
            state.optimizer.step()
        return torch.stack([loss, *terms]).detach()

    def _sgd_step(self, state: TrainState, mb: UpdateBatch) -> torch.Tensor:
        """One SGD step on a minibatch (BatchNorm in train mode) -> the
        ``_AUX`` metrics stacked ``(6,)``, on the device, a tensor of its
        own. With ``graph_sgd`` (by default on a CUDA device with one rank)
        the step runs on an :class:`_SgdGraph`'s buffers, one CUDA graph
        replay after its warm-ups, built at the first step and again when
        what its capture fixes changes (:meth:`_SgdGraph.key_of`: a new
        minibatch shape, model, optimiser state, ...); else eagerly."""
        profiler.count("ppo.sgd_steps", 1)
        if not self.graph_sgd:
            return self._sgd_eager(state, mb)
        key = _SgdGraph.key_of(self, state, mb)
        if self._sgd_graph is None or self._sgd_graph.key != key:
            self._sgd_graph = None  # the old graph and buffers go first
            self._sgd_graph = _SgdGraph(key, state, mb)
        return self._sgd_graph.step(self, state, mb)

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
