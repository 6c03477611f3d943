"""Single-env adapter with the reference env's behaviour, in numpy
(counterpart of ``gym2048_tpu/env/adapter.py``).

:class:`Game2048Env` is the reference ``Game2048Env`` (game2048_env.py:34-288)
without gymnasium: the same ``reset``/``step``/``render``, the same
game-specific extensions (``move``/``shift``/``set_board``/``get_board``/
``highest``/``empties``/``isend``/``set_illegal_move_reward``/
``set_max_tile``) and the **same RNG stream**: tile spawns consume one
``np_random.random()`` and one ``np_random.shuffle`` of the 16-position list
per spawn, and ``reset(seed=...)`` seeds as ``gymnasium.Env.reset`` does (a
seed makes a new generator; ``None`` keeps the current one, or makes one
from fresh entropy if there is none yet), so trajectories under a fixed
seed are bit-exact with the reference (tests/fixtures/).

It imports no gymnasium, so it runs where gymnasium is not installed. The
gymnasium class, with the base, the spaces and the ``Torch2048-v0`` id, is
``gym2048_tpu_torch.env.registration.GymGame2048Env``. The device path is the
batched env (``gym2048_tpu_torch.env.batched``), whose ``reset_parity`` and
``step_parity`` replay this adapter's streams (``env/parity.py``).
"""

from __future__ import annotations

import logging
import sys
from io import StringIO

import numpy as np

from gym2048_tpu_torch.core import rules_np
from gym2048_tpu_torch.env.parity import np_random as _seeded


class IllegalMove(Exception):
    """Raised by ``move`` when the move does not change the board."""


def stack_np(board: np.ndarray, layers: int = 15) -> np.ndarray:
    """Value board (4, 4) -> (layers+1, 4, 4) one-hot env observation.

    Channel 0 marks empty cells; channels 1..layers mark tiles 2^1..2^layers
    (reference ``stack``, game2048_env.py:17-32).
    """
    flat = np.asarray(board)
    empty = (flat == 0).astype(int)[np.newaxis]
    reps = 2 ** (np.arange(layers, dtype=int) + 1)
    value_layers = (flat[np.newaxis] == reps[:, None, None]).astype(int)
    return np.concatenate([empty, value_layers], axis=0)


def unstack_np(stacked: np.ndarray, layers: int = 15) -> np.ndarray:
    """Inverse of :func:`stack_np` (reference gather_training_data.py:71-75)."""
    reps = 2 ** (np.arange(layers, dtype=int) + 1)
    return np.sum(stacked[1:] * reps[:, None, None], axis=0)


class Game2048Env:
    """Single 4x4 2048 environment with reference-exact behaviour."""

    metadata = {"render_modes": ["ansi", "human", "rgb_array"], "render_fps": 4}
    _all_positions = [(r, c) for r in range(4) for c in range(4)]
    _np_random: np.random.Generator | None = None
    _np_random_seed: int | None = None

    def __init__(self, render_mode: str | None = None):
        self.size = 4
        self.w = self.h = self.size
        self.squares = self.size * self.size
        self.score = 0.0
        self.set_illegal_move_reward(0.0)
        self.set_max_tile(None)

        self.grid_size = 70
        self.render_mode = render_mode
        self.board = np.zeros((self.h, self.w), int)

    # -- seeding, as gymnasium.Env's ------------------------------------------
    @property
    def np_random(self) -> np.random.Generator:
        """The spawn generator; made from fresh entropy at first use if no
        ``reset(seed=...)`` came before."""
        if self._np_random is None:
            self._np_random, self._np_random_seed = _seeded()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator) -> None:
        self._np_random, self._np_random_seed = value, -1

    @property
    def np_random_seed(self) -> int:
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = _seeded()
        return self._np_random_seed

    # -- board as the reference exposes it ---------------------------------
    @property
    def Matrix(self) -> np.ndarray:  # noqa: N802 — reference attribute name
        return self.board

    @Matrix.setter
    def Matrix(self, value: np.ndarray) -> None:  # noqa: N802
        self.board = value

    # -- configuration ------------------------------------------------------
    def set_illegal_move_reward(self, reward: float) -> None:
        """Reward for an illegal move; also updates ``reward_range``."""
        self.illegal_move_reward = reward
        self.reward_range = (self.illegal_move_reward, float(2**self.squares))

    def set_max_tile(self, max_tile: int | None) -> None:
        """Tile value that ends the game when reached exactly (None = none)."""
        assert max_tile is None or isinstance(max_tile, int)
        self.max_tile = max_tile

    # -- the env interface ---------------------------------------------------
    def step(self, action):
        """Move, spawn a tile, check for game end (game2048_env.py:76-100)."""
        logging.debug("Action %s", action)
        info = {"illegal_move": False}
        try:
            score = float(self.move(action))
            self.score += score
            assert score <= 2 ** (self.w * self.h)
            self.add_tile()
            terminated = self.isend()
            reward = float(score)
        except IllegalMove:
            logging.debug("Illegal move")
            info["illegal_move"] = True
            terminated = True
            reward = self.illegal_move_reward

        info["highest"] = self.highest()
        return stack_np(self.board), reward, terminated, False, info

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._np_random, self._np_random_seed = _seeded(seed)
        self.board = np.zeros((self.h, self.w), int)
        self.score = 0.0
        self.add_tile()
        self.add_tile()
        return stack_np(self.board), {}

    def render(self, mode: str | None = None):
        if mode is None:
            mode = self.render_mode or "human"
        if mode == "rgb_array":
            from gym2048_tpu_torch.utils.render import render_rgb

            return render_rgb(self.board, grid_size=self.grid_size)
        outfile = StringIO() if mode == "ansi" else sys.stdout
        s = f"Score: {self.score}\n"
        s += f"Highest: {self.highest()}\n"
        s += f"{np.asarray(self.board).reshape(self.size, self.size)}\n"
        outfile.write(s)
        return outfile

    def close(self) -> None:
        pass

    # -- game mechanics ------------------------------------------------------
    def add_tile(self) -> None:
        """Spawn 2 (p=0.9) or 4 at the first empty cell of a shuffled order.

        RNG consumption matches the reference exactly: one ``random()`` then
        one ``shuffle`` of the 16-position list per call
        (game2048_env.py:166-176).
        """
        val = 2 if self.np_random.random() < 0.9 else 4
        positions = self._all_positions.copy()
        self.np_random.shuffle(positions)
        for r, c in positions:
            if self.board[r, c] == 0:
                self.board[r, c] = val
                return
        raise AssertionError("No empty cell found")

    def get(self, x: int, y: int):
        return self.board[x, y]

    def set(self, x: int, y: int, val: int) -> None:
        self.board[x, y] = val

    def empties(self) -> np.ndarray:
        return np.argwhere(self.board == 0)

    def highest(self):
        return np.max(self.board)

    def move(self, direction: int, trial: bool = False) -> int:
        """Apply a move; raise :class:`IllegalMove` if nothing changes.

        Directions 0=up 1=right 2=down 3=left. Returns the merge score.
        """
        new_board, score, changed = rules_np.move(self.board, direction)
        if not changed:
            raise IllegalMove
        if not trial:
            self.board = np.asarray(new_board, dtype=int)
        return score

    def shift(self, row):
        """Compact+merge one row leftward; returns ``(new_row, score)``."""
        return rules_np.shift_row_left(row)

    def isend(self) -> bool:
        """Game over: ``max_tile`` reached exactly, or no legal move."""
        if self.max_tile is not None and self.highest() == self.max_tile:
            return True
        return rules_np.is_dead(self.board)

    def get_board(self) -> np.ndarray:
        return self.board

    def set_board(self, new_board: np.ndarray) -> None:
        self.board = new_board
