"""Gymnasium class and registration (counterpart of
``gym2048_tpu/env/registration.py``).

:class:`GymGame2048Env` is the numpy :class:`~gym2048_tpu_torch.env.adapter.
Game2048Env` with gymnasium's ``Env`` base and the reference's spaces
(``Discrete(4)`` actions, ``Box(0, 1, (16, 4, 4))`` one-hot observations);
it adds nothing else. Importing this module imports gymnasium and
registers the class as ``Torch2048-v0``, the port's own id: the JAX package
registers ``Tpu2048-v0`` and ``2048-v0``, and both packages may share one
process.
"""

from __future__ import annotations

import gymnasium as gym
from gymnasium import spaces

from gym2048_tpu_torch.env.adapter import Game2048Env

ENV_ID = "Torch2048-v0"


class GymGame2048Env(Game2048Env, gym.Env):
    """:class:`Game2048Env` as a ``gymnasium.Env``."""

    metadata = Game2048Env.metadata

    def __init__(self, render_mode: str | None = None):
        super().__init__(render_mode=render_mode)
        self.action_space = spaces.Discrete(4)
        self.observation_space = spaces.Box(0, 1, (self.squares, self.w, self.h), dtype=int)


def register_gym() -> None:
    """Register :class:`GymGame2048Env` as ``Torch2048-v0`` unless it is."""
    if ENV_ID not in gym.registry:
        gym.register(id=ENV_ID, entry_point="gym2048_tpu_torch.env.registration:GymGame2048Env")


register_gym()
