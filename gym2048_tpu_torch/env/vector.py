"""Gymnasium ``VectorEnv`` facade over the batched env (counterpart of
``gym2048_tpu/env/vector.py``).

The reference gets its (sequential) vectorisation from SB3's
``make_vec_env`` (ppo_train.py:123); users of the Gymnasium ecosystem expect
a ``gymnasium.vector.VectorEnv``. This wrapper exposes the lockstep env of
``env/batched.py`` on an explicit device through that API: ``reset``/
``step`` with auto-reset semantics, numpy in and out, observation space
``(num_envs, 16, 4, 4)``. Its spawns come from a ``torch.Generator`` seeded
by ``seed`` on that device. It imports gymnasium; the learners do not go
through it.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
import torch
from gymnasium import spaces

from gym2048_tpu_torch.core import rules
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.env.batched import EnvConfig
from gym2048_tpu_torch.ops import obs as obs_ops


class BatchedVectorEnv(gym.vector.VectorEnv):
    """``num_envs`` lockstep 2048 envs on ``device`` (the card unless the
    caller says otherwise)."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, num_envs: int = 8, config: EnvConfig = EnvConfig(), seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.num_envs = num_envs
        self.config = config
        self.device = torch.device(device)
        self.single_observation_space = spaces.Box(0, 1, (16, 4, 4), dtype=np.int64)
        self.single_action_space = spaces.Discrete(4)
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)
        self._seed = seed
        self._generator: torch.Generator | None = None
        self._state: batched.EnvState | None = None

    def _obs(self, board: torch.Tensor) -> np.ndarray:
        # int32 on the device, the declared int64 Box dtype on the host
        return obs_ops.env_stack(board, dtype=torch.int32).cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------- gym API
    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._seed = seed
        self._generator = torch.Generator(device=self.device).manual_seed(self._seed)
        self._state = batched.reset(self._generator, self.num_envs, device=self.device)
        return self._obs(self._state.board), {}

    def step(self, actions):
        assert self._state is not None, "call reset() first"
        actions = torch.as_tensor(np.asarray(actions), dtype=torch.int32, device=self.device)
        self._state, ts = batched.step(self._state, actions, self.config,
                                       generator=self._generator)
        # post-auto-reset boards, in the declared observation dtype
        infos = {"illegal_move": ts.illegal.cpu().numpy(),
                 "highest": ts.highest.cpu().numpy(),
                 "score": ts.score.cpu().numpy()}
        return (self._obs(ts.board), ts.reward.cpu().numpy(), ts.terminated.cpu().numpy(),
                ts.truncated.cpu().numpy(), infos)

    def render(self):
        from gym2048_tpu_torch.utils.render import render_rgb

        return render_rgb(rules.exp_to_value(self._state.board[0]).cpu().numpy())

    def close(self, **kwargs):
        self._state = None
