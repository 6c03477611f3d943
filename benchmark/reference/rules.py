"""The 2048 rules and the batched environment, written plainly for the check.

Boards are ``(B, 4, 4)`` int8 tile exponents (0 empty, k the tile 2**k).
A move slides every row towards one side: the non-empty cells close up,
then equal neighbours merge once each, from the side the row moves to;
the merge score is the sum of the created tiles' values. Directions are
0 up, 1 right, 2 down, 3 left, and a move is legal iff it changes the
board. A spawn puts exponent 1 (uniform below 0.9) or 2 on the k-th empty
cell in row-major order, k = min(trunc(u_pos * empties), empties - 1)
computed in float32; a full board is left as it is.

A move is read from a table of every row of four exponents below
``EXP_LIMIT``, built once by a Python loop over the rows (the rule as a
person states it), and applied to all rows at once by indexing.

Nothing here imports the program under test.
"""

from __future__ import annotations

import functools
import itertools

import torch

# exponents 0..19 index the row table: a real board holds at most 2**17, and
# the search's spawn children of occupied cells (probability 0) two more
EXP_LIMIT = 20


def _slide_row(row: tuple[int, ...]) -> tuple[list[int], int]:
    """One row slid to the left: (new row, merge score)."""
    cells = [e for e in row if e]
    out, score, i = [], 0, 0
    while i < len(cells):
        if i + 1 < len(cells) and cells[i] == cells[i + 1]:
            out.append(cells[i] + 1)
            score += 1 << (cells[i] + 1)
            i += 2
        else:
            out.append(cells[i])
            i += 1
    return out + [0] * (4 - len(out)), score


@functools.cache
def _row_table_cpu() -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (EXP_LIMIT**4, 4) int64, scores (EXP_LIMIT**4,) int64) of every
    row, row ``sum(e[k] * EXP_LIMIT**k)`` at that index."""
    out_rows, out_scores = [], []
    for e3, e2, e1, e0 in itertools.product(range(EXP_LIMIT), repeat=4):
        new, score = _slide_row((e0, e1, e2, e3))
        out_rows.append(new)
        out_scores.append(score)
    return (torch.tensor(out_rows, dtype=torch.int64).clamp(max=EXP_LIMIT - 1),
            torch.tensor(out_scores, dtype=torch.int64))


_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _row_table(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    if device not in _TABLES:
        rows, scores = _row_table_cpu()
        _TABLES[device] = (rows.to(device), scores.to(device))
    return _TABLES[device]


def _oriented(board: torch.Tensor, direction: int) -> torch.Tensor:
    """The board turned so that ``direction`` slides each row to the left."""
    if direction == 3:
        return board
    if direction == 1:
        return board.flip(-1)
    if direction == 0:
        return board.transpose(-1, -2)
    return board.transpose(-1, -2).flip(-1)


def _restored(rows: torch.Tensor, direction: int) -> torch.Tensor:
    """The inverse of :func:`_oriented`."""
    if direction == 3:
        return rows
    if direction == 1:
        return rows.flip(-1)
    if direction == 0:
        return rows.transpose(-1, -2)
    return rows.flip(-1).transpose(-1, -2)


def move_all(board: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every move of ``(N, 4, 4)`` boards: (after (N, 4, 4, 4) int8 indexed
    (board, direction), score (N, 4) int64, legal (N, 4) bool)."""
    rows_t, scores_t = _row_table(board.device)
    b = board.to(torch.int64)
    weights = torch.tensor([EXP_LIMIT ** k for k in range(4)], device=board.device)
    afters, scores = [], []
    for d in range(4):
        o = _oriented(b, d)
        code = (o.clamp(max=EXP_LIMIT - 1) * weights).sum(-1)  # (N, 4) one code a row
        afters.append(_restored(rows_t[code], d))
        scores.append(scores_t[code].sum(-1))
    after = torch.stack(afters, 1)
    legal = (after != b[:, None]).flatten(2).any(-1)
    return after.to(torch.int8), torch.stack(scores, 1), legal


def spawn(board: torch.Tensor, u_val: torch.Tensor, u_pos: torch.Tensor) -> torch.Tensor:
    """One spawn on each of ``(N, 4, 4)`` boards (see the module docstring)."""
    flat = board.reshape(-1, 16)
    empty = flat == 0
    n_empty = empty.sum(-1)
    k = torch.minimum((u_pos * n_empty.to(torch.float32)).to(torch.int64), n_empty - 1)
    rank = empty.cumsum(-1) - 1  # rank of each empty cell among the empties
    hit = empty & (rank == k[:, None])
    tile = torch.where(u_val < 0.9, 1, 2).to(board.dtype)
    return (flat + hit.to(board.dtype) * tile[:, None]).reshape(board.shape)


def fresh_boards(u: torch.Tensor) -> torch.Tensor:
    """Empty boards with two spawns, from ``(N, 4)`` uniforms (value,
    position, value, position)."""
    board = torch.zeros((u.shape[0], 4, 4), dtype=torch.int8, device=u.device)
    return spawn(spawn(board, u[:, 0], u[:, 1]), u[:, 2], u[:, 3])


def highest_tile(board: torch.Tensor) -> torch.Tensor:
    """The highest tile's value (0 for an empty board), int64."""
    e = board.reshape(-1, 16).amax(-1).to(torch.int64)
    return torch.where(e > 0, torch.ones_like(e) << e, 0)


def env_step(board, score, steps, action, u, auto_reset: bool, illegal_reward: float = 0.0):
    """One step of the batched environment with the six uniforms ``u (N, 6)``
    of each board: the chosen move, a spawn after a legal one (columns 0-1),
    the end of a game when the move is illegal or leaves a dead board, and,
    with ``auto_reset``, a fresh board (columns 2-5) in place of an ended one.

    Returns ``(board, score, steps, reward, terminated, highest, game_score,
    game_steps)``: the next state, then the step's reward, whether it ended
    the game, the highest tile, the game's score and length with this step
    (before any reset)."""
    after_all, score_all, legal_all = move_all(board)
    pick = action.to(torch.int64)[:, None]
    after = after_all.gather(1, pick[:, :, None, None].expand(-1, 1, 4, 4))[:, 0]
    gain = score_all.gather(1, pick)[:, 0]
    legal = legal_all.gather(1, pick)[:, 0]
    moved = torch.where(legal[:, None, None], spawn(after, u[:, 0], u[:, 1]), board)
    dead = ~move_all(moved)[2].any(-1)
    terminated = ~legal | dead
    reward = torch.where(legal, gain.to(torch.float32), illegal_reward)
    game_score = score + torch.where(legal, gain, 0).to(torch.float32)
    game_steps = steps + 1
    highest = highest_tile(moved)
    if auto_reset:
        nxt = torch.where(terminated[:, None, None], fresh_boards(u[:, 2:6]), moved)
        nscore = torch.where(terminated, 0.0, game_score)
        nsteps = torch.where(terminated, 0, game_steps)
    else:
        nxt, nscore, nsteps = moved, game_score, game_steps
    return nxt, nscore, nsteps, reward, terminated, highest, game_score, game_steps
