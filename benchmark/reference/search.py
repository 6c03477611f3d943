"""The adaptive-depth afterstate expectimax agent, written plainly.

The values are those of an afterstate value function V in score units (an
n-tuple network). A move's value at one ply is ``reward + V(afterstate)``;
each further ply takes the expectation over the afterstate's spawns (a 2
with probability 0.9, a 4 with 0.1, uniform over the empty cells) of the
best value of the spawned board's moves, a board with no move being worth
0; an illegal move is worth -1e9. The agent values every board's moves at
two plies; then the ``k_deep`` live boards with the fewest empty cells, at
most ``deep_empty_max`` (ties to the lower index), are valued again at three
plies, where the middle level expands only the move that is best at one
ply (a beam) and keeps the other moves' one-ply values. The agent plays the
first move of the largest value.

Spawn children are laid out as 16 cells with a 2, then 16 with a 4; an
occupied cell's child has probability 0.

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference import rules

NEG = -1e9


def spawn_children(boards: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(children (N, 32, 4, 4), probabilities (N, 32))``."""
    n = boards.shape[0]
    flat = boards.reshape(n, 16)
    empty = flat == 0
    share = 1.0 / empty.sum(-1).clamp(min=1).to(torch.float32)
    p = torch.where(empty, share[:, None], 0.0)
    one = torch.eye(16, dtype=boards.dtype, device=boards.device)
    kids = torch.cat([flat[:, None] + one, flat[:, None] + 2 * one], 1)
    return kids.reshape(n, 32, 4, 4), torch.cat([0.9 * p, 0.1 * p], 1)


def move_values(value, boards: torch.Tensor, plies: int, beam: bool = False) -> torch.Tensor:
    """Values ``(N, 4)`` of the four moves of ``boards`` at ``plies`` plies."""
    n = boards.shape[0]
    after, gain, legal = rules.move_all(boards)
    gain = gain.to(torch.float32)
    if plies == 1:
        v = value(after.reshape(n * 4, 4, 4)).reshape(n, 4)
        return torch.where(legal, gain + v, NEG)

    def best(children):
        q = move_values(value, children, plies - 1, beam)
        return torch.where((q > NEG / 2).any(-1), q.amax(-1), 0.0)

    if beam and plies == 2:
        shallow = torch.where(legal, gain + value(after.reshape(n * 4, 4, 4)).reshape(n, 4), NEG)
        a = shallow.argmax(-1, keepdim=True)
        chosen = after.gather(1, a[:, :, None, None].expand(-1, 1, 4, 4))[:, 0]
        kids, p = spawn_children(chosen)
        deep = gain.gather(1, a) + (best(kids.reshape(n * 32, 4, 4)).reshape(n, 32) * p).sum(
            -1, keepdim=True)
        return shallow.scatter(1, a, torch.where(legal.gather(1, a), deep, NEG))
    kids, p = spawn_children(after.reshape(n * 4, 4, 4))
    expect = (best(kids.reshape(n * 128, 4, 4)).reshape(n * 4, 32) * p).sum(-1).reshape(n, 4)
    return torch.where(legal, gain + expect, NEG)


def deep_set(boards: torch.Tensor, live: torch.Tensor, k_deep: int,
             deep_empty_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the boards valued at three plies, and whether each qualifies."""
    empties = (boards.reshape(boards.shape[0], 16) == 0).sum(-1)
    ok = live & (empties <= deep_empty_max)
    danger = torch.where(ok, -empties, -(10 ** 6))
    top = torch.sort(danger, descending=True, stable=True).indices[:min(k_deep, boards.shape[0])]
    return top, ok[top]


def adaptive_values(value, boards: torch.Tensor, live: torch.Tensor, k_deep: int,
                    deep_empty_max: int) -> torch.Tensor:
    """The agent's move values ``(N, 4)`` (see the module docstring)."""
    q = move_values(value, boards, 2)
    top, ok = deep_set(boards, live, k_deep, deep_empty_max)
    deep = move_values(value, boards[top], 3, beam=True)
    return q.index_copy(0, top, torch.where(ok[:, None], deep, q[top]))
