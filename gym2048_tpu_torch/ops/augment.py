"""The 8x symmetry augmentation of (board, action, next board) batches
(counterpart of ``gym2048_tpu/ops/augment.py``).

A horizontal flip swaps actions right (1) and left (3); a k x 90-degree
rotation shifts actions by k (mod 4); :func:`augment8` concatenates
[original, hflip] x 4 rotations, the reference's order. Boards are
``(N, 4, 4)`` (any values: only cells move), actions int tensors of any
shape.
"""

from __future__ import annotations

import torch


def hflip_boards(boards: torch.Tensor) -> torch.Tensor:
    """Flip boards left-right."""
    return boards.flip(-1)


def hflip_actions(actions: torch.Tensor) -> torch.Tensor:
    """Swap actions 1 (right) and 3 (left); 0 and 2 unchanged."""
    return torch.where(actions == 1, 3, torch.where(actions == 3, 1, actions))


def rotate_boards(boards: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate each board by k x 90 degrees, as ``np.rot90(axes=(2, 1))``."""
    return torch.rot90(boards, k, dims=(-1, -2))


def rotate_actions(actions: torch.Tensor, k: int) -> torch.Tensor:
    """Actions after a k x 90-degree rotation: (a + k) mod 4."""
    return torch.remainder(actions + k, 4)


def augment8(boards: torch.Tensor, actions: torch.Tensor,
             next_boards: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """The 8x dihedral augmentation in the reference's order: the identity
    and hflip pair, then that pair rotated by 1, 2 and 3 quarter turns.
    Returns ``(boards_8N, actions_8N[, next_boards_8N])``."""
    pair_b = torch.cat([boards, hflip_boards(boards)])
    pair_a = torch.cat([actions, hflip_actions(actions)])
    result = [torch.cat([rotate_boards(pair_b, k) for k in range(4)]),
              torch.cat([rotate_actions(pair_a, k) for k in range(4)])]
    if next_boards is not None:
        pair_n = torch.cat([next_boards, hflip_boards(next_boards)])
        result.append(torch.cat([rotate_boards(pair_n, k) for k in range(4)]))
    return tuple(result)
