"""Batched 2048 environment with auto-reset, in PyTorch.

Port of ``gym2048_tpu/env/batched.py``: ``step`` advances B boards in
lockstep, with the reference game's semantics per board:

* move -> (on success) spawn -> terminal check;
* an illegal move leaves the board unchanged, spawns nothing, terminates
  the episode and yields ``illegal_move_reward``;
* the reward is the move's merge score, and ``score`` accumulates it;
* ``highest`` is the highest tile after the step (before any reset);
* an optional ``max_tile`` ends the episode when reached exactly;
* with auto-reset a terminated board is replaced by a fresh one, which is
  what ``TimeStep.board`` shows (``final_board`` keeps the transition's
  result).

Randomness: the JAX env keeps a key in its state and draws ``(B, 6)``
uniforms per step and ``(B, 4)`` per reset. Here the caller passes a
``torch.Generator`` to draw them from, or the uniforms themselves as ``u=``
(the tests hand both packages the same numbers that way). Columns 0-1 of a
step's uniforms drive the spawn after the move, columns 2-5 the two spawns
of an auto-reset; a reset's four columns are (value, position, value,
position). The JAX key has no counterpart in :class:`EnvState`.

There is no kernel here: the JAX env leaves the step to XLA, and this port
leaves it to PyTorch's own operators.
"""

from __future__ import annotations

import dataclasses

import torch

from gym2048_tpu_torch.core import rules


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration.

    Attributes:
        illegal_move_reward: reward for an illegal move.
        max_tile: tile value that ends the game when reached exactly
            (0 = no limit).
        auto_reset: replace terminated boards with freshly reset ones.
    """

    illegal_move_reward: float = 0.0
    max_tile: int = 0
    auto_reset: bool = True

    @property
    def max_tile_exp(self) -> int:
        if self.max_tile <= 0:
            return 0
        exp = self.max_tile.bit_length() - 1
        if 1 << exp != self.max_tile:
            raise ValueError(f"max_tile must be a power of two, got {self.max_tile}")
        return exp


@dataclasses.dataclass(frozen=True)
class EnvState:
    """State of B environments.

    Attributes:
        board: ``(B, 4, 4)`` int8 log2-exponent boards.
        score: ``(B,)`` float32 accumulated game score.
        done: ``(B,)`` bool, the held board is terminal (only with
            ``auto_reset=False``).
        step_count: ``(B,)`` int32 steps taken in the current episode.
    """

    board: torch.Tensor
    score: torch.Tensor
    done: torch.Tensor
    step_count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TimeStep:
    """Result of one batched step; see ``gym2048_tpu.env.batched.TimeStep``."""

    board: torch.Tensor        # (B, 4, 4) int8, after auto-reset
    final_board: torch.Tensor  # (B, 4, 4) int8, before auto-reset
    reward: torch.Tensor       # (B,) float32
    terminated: torch.Tensor   # (B,) bool
    truncated: torch.Tensor    # (B,) bool, always False
    illegal: torch.Tensor      # (B,) bool
    highest: torch.Tensor      # (B,) int32 tile value
    score: torch.Tensor        # (B,) float32 game score including this step
    steps: torch.Tensor        # (B,) int32 episode length including this step


def _uniforms(u, generator, shape, device) -> torch.Tensor:
    """The caller's uniforms ``u``, or ``shape`` fresh ones from ``generator``."""
    if u is not None:
        if tuple(u.shape) != shape or u.dtype != torch.float32:
            raise ValueError(f"u must be float32 of shape {shape}, got "
                             f"{u.dtype} {tuple(u.shape)}")
        return u
    if generator is None:
        raise ValueError("pass a torch.Generator or the uniforms u=")
    return torch.rand(shape, generator=generator, device=device)


def _fresh_boards(u: torch.Tensor) -> torch.Tensor:
    """Empty boards plus two spawned tiles; ``u`` is ``(B, 4)`` uniforms."""
    board = torch.zeros(u.shape[:-1] + (4, 4), dtype=rules.BOARD_DTYPE,
                        device=u.device)
    board = rules.spawn(board, u[..., 0], u[..., 1])
    return rules.spawn(board, u[..., 2], u[..., 3])


def reset(generator: torch.Generator | None, batch_size: int, *,
          device: str | torch.device = "cuda",
          u: torch.Tensor | None = None) -> EnvState:
    """Create ``batch_size`` freshly reset environments on ``device``."""
    u = _uniforms(u, generator, (batch_size, 4), device)
    board = _fresh_boards(u.to(device))
    return EnvState(
        board=board,
        score=torch.zeros(batch_size, dtype=torch.float32, device=device),
        done=torch.zeros(batch_size, dtype=torch.bool, device=device),
        step_count=torch.zeros(batch_size, dtype=torch.int32, device=device),
    )


def move_products(state: EnvState):
    """All-directions move results for the current boards:
    ``(moved (B,4,4,4), scores (B,4), changed (B,4))``. Pass them to
    :func:`step_with_products` when the caller also needs the legality mask.
    """
    return rules.move_all(state.board)


def step(state: EnvState, action: torch.Tensor,
         config: EnvConfig = EnvConfig(), *,
         generator: torch.Generator | None = None,
         u: torch.Tensor | None = None) -> tuple[EnvState, TimeStep]:
    """Advance all B environments by one action each (0=up 1=right 2=down
    3=left). Uniforms come from ``u (B, 6)`` or else from ``generator``."""
    return step_with_products(state, action, move_products(state), config,
                              generator=generator, u=u)


def _transition(state, action, products, config, spawn_fn):
    """Move, spawn with ``spawn_fn(board_after)``, and score one step.

    Shared by :func:`step_with_products` and :func:`step_parity`; returns
    ``(new_board, terminated, legal, reward, new_score, highest, new_steps)``.
    """
    moved, scores, changed = products
    board_after, move_score, legal = rules._select_direction(
        moved, scores, changed, action)
    spawned = spawn_fn(board_after)
    new_board = torch.where(legal[:, None, None], spawned, state.board)

    dead = rules.is_dead(new_board)
    max_exp = new_board.flatten(-2).amax(dim=-1).to(torch.int32)
    if config.max_tile_exp > 0:
        terminated = ~legal | dead | (max_exp == config.max_tile_exp)
    else:
        terminated = ~legal | dead

    reward = torch.where(legal, move_score.to(torch.float32),
                         config.illegal_move_reward)
    new_score = state.score + torch.where(
        legal, move_score, torch.zeros_like(move_score)).to(torch.float32)
    highest_val = torch.where(max_exp > 0, rules._shl1(max_exp),
                              torch.zeros_like(max_exp))
    new_steps = state.step_count + 1
    return new_board, terminated, legal, reward, new_score, highest_val, new_steps


def step_with_products(state: EnvState, action: torch.Tensor, products,
                       config: EnvConfig = EnvConfig(), *,
                       generator: torch.Generator | None = None,
                       u: torch.Tensor | None = None
                       ) -> tuple[EnvState, TimeStep]:
    """Like :func:`step`, with the :func:`move_products` precomputed."""
    batch = state.board.shape[0]
    u = _uniforms(u, generator, (batch, 6), state.board.device)
    new_board, terminated, legal, reward, new_score, highest_val, new_steps = (
        _transition(state, action, products, config,
                    lambda b: rules.spawn(b, u[:, 0], u[:, 1])))

    if config.auto_reset:
        fresh = _fresh_boards(u[:, 2:6])
        out_board = torch.where(terminated[:, None, None], fresh, new_board)
        out_score = torch.where(terminated, 0.0, new_score)
        out_steps = torch.where(terminated, torch.zeros_like(new_steps),
                                new_steps)
        out_done = torch.zeros_like(terminated)
    else:
        out_board, out_score, out_steps = new_board, new_score, new_steps
        out_done = terminated

    new_state = EnvState(board=out_board, score=out_score, done=out_done,
                         step_count=out_steps)
    ts = TimeStep(
        board=out_board,
        final_board=new_board,
        reward=reward,
        terminated=terminated,
        truncated=torch.zeros_like(terminated),
        illegal=~legal,
        highest=highest_val,
        score=new_score,
        steps=new_steps,
    )
    return new_state, ts


def reset_parity(spawn_vals: torch.Tensor, spawn_ranks: torch.Tensor) -> EnvState:
    """Parity-mode reset from host-drawn spawns: ``spawn_vals (B, 2)`` tile
    exponents and ``spawn_ranks (B, 2, 16)`` shuffle orders of the
    reference's NumPy stream, applied with :func:`rules.spawn_ranked`."""
    batch = spawn_vals.shape[0]
    device = spawn_vals.device
    board = torch.zeros((batch, 4, 4), dtype=rules.BOARD_DTYPE, device=device)
    for i in range(2):
        board = rules.spawn_ranked(board, spawn_vals[:, i], spawn_ranks[:, i])
    return EnvState(
        board=board,
        score=torch.zeros(batch, dtype=torch.float32, device=device),
        done=torch.zeros(batch, dtype=torch.bool, device=device),
        step_count=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def step_parity(state: EnvState, action: torch.Tensor,
                spawn_val: torch.Tensor, spawn_rank: torch.Tensor,
                config: EnvConfig = EnvConfig(auto_reset=False)
                ) -> tuple[EnvState, TimeStep]:
    """Parity-mode step: the spawn of each board is ``spawn_val (B,)`` at the
    empty cell of least ``spawn_rank (B, 16)``. An illegal move applies no
    spawn, as the reference consumes no draw then. No auto-reset
    (``config.auto_reset`` is ignored)."""
    new_board, terminated, legal, reward, new_score, highest_val, new_steps = (
        _transition(state, action, move_products(state), config,
                    lambda b: rules.spawn_ranked(b, spawn_val, spawn_rank)))
    new_state = EnvState(board=new_board, score=new_score, done=terminated,
                         step_count=new_steps)
    ts = TimeStep(
        board=new_board,
        final_board=new_board,
        reward=reward,
        terminated=terminated,
        truncated=torch.zeros_like(terminated),
        illegal=~legal,
        highest=highest_val,
        score=new_score,
        steps=new_steps,
    )
    return new_state, ts


def legal_actions(state: EnvState) -> torch.Tensor:
    """``(B, 4)`` bool mask of the actions that would change each board."""
    _, _, changed = rules.move_all(state.board)
    return changed
