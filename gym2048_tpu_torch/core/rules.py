"""Branch-free 2048 rules on batches of exponent boards, in PyTorch.

Port of ``gym2048_tpu/core/rules.py``. The JAX module works on one board and
is batched with ``vmap``; here the batch dimension is written out: every
function takes boards of shape ``(..., 4, 4)`` (in practice ``(B, 4, 4)``)
and returns per-board results with the same leading shape.

Boards hold **log2 exponents** as int8: ``0`` is an empty cell and ``k`` is
the tile ``2**k``. Arithmetic runs in int32. The semantics are those of the
reference game (see the JAX module's docstring): single-pass leftmost-first
compact and merge, directions 0=up 1=right 2=down 3=left, a move is legal
iff it changes the board, the merge score is the sum of the created tiles'
values, and a spawn places exponent 1 (p=0.9) or 2 uniformly over the empty
cells.
"""

from __future__ import annotations

import torch

UP, RIGHT, DOWN, LEFT = 0, 1, 2, 3

BOARD_DTYPE = torch.int8


def _shl1(e: torch.Tensor) -> torch.Tensor:
    """``1 << e`` for an int32 tensor ``e``."""
    return torch.ones_like(e) << e


def _compact_merge_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift ``(..., 4)`` int32 exponent rows left: compact, then merge pairs.

    Returns ``(new_rows (..., 4) int32, scores (...,) int32)``, the score
    being the sum of merged tile values per row (``rules._compact_merge_rows``).
    """
    a = [rows[..., i] for i in range(4)]
    nz = [x != 0 for x in a]
    nzi = [x.to(torch.int32) for x in nz]
    pos = [torch.zeros_like(nzi[0]), nzi[0], nzi[0] + nzi[1],
           nzi[0] + nzi[1] + nzi[2]]
    c = []
    for k in range(4):
        slot = torch.zeros_like(a[0])
        for j in range(k, 4):  # cell j can only land at slot <= j
            slot = torch.where(nz[j] & (pos[j] == k), a[j], slot)
        c.append(slot)
    c0, c1, c2, c3 = c

    # Single-pass merge: m01 consumes c1, m12 consumes c2; m01 and m23 may
    # both fire ([4,4,4,4] -> [8,8]).
    m01 = (c0 != 0) & (c0 == c1)
    m12 = (c1 != 0) & (c1 == c2) & ~m01
    m23 = (c2 != 0) & (c2 == c3) & ~m12
    i01, i12, i23 = (m.to(torch.int32) for m in (m01, m12, m23))
    zero = torch.zeros_like(c0)

    out0 = c0 + i01
    out1 = torch.where(m01, c2 + i23, c1 + i12)
    out2 = torch.where(m01, torch.where(m23, zero, c3),
                       torch.where(m12, c3, c2 + i23))
    out3 = torch.where(m01 | m12 | m23, zero, c3)
    score = (i01 * _shl1(c0 + 1) + i12 * _shl1(c1 + 1)
             + i23 * _shl1(c2 + 1))
    return torch.stack([out0, out1, out2, out3], dim=-1), score


def _orient(board: torch.Tensor) -> torch.Tensor:
    """``(..., 4, 4)`` -> ``(..., 4dir, 4, 4)``: each move becomes a left shift."""
    t = board.transpose(-1, -2)
    return torch.stack([t, board.flip(-1), t.flip(-1), board], dim=-3)


def _unorient(oriented: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_orient` per direction."""
    up = oriented[..., 0, :, :].transpose(-1, -2)
    right = oriented[..., 1, :, :].flip(-1)
    down = oriented[..., 2, :, :].flip(-1).transpose(-1, -2)
    left = oriented[..., 3, :, :]
    return torch.stack([up, right, down, left], dim=-3)


def move_all(board: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All four moves of ``(..., 4, 4)`` boards at once (``rules.move_all``).

    Returns:
        moved:   ``(..., 4, 4, 4)`` board after each move (dir, row, col),
                 in the boards' dtype.
        scores:  ``(..., 4)`` int32 merge score per direction.
        changed: ``(..., 4)`` bool, whether the move alters the board.
    """
    oriented = _orient(board.to(torch.int32))
    new_rows, row_scores = _compact_merge_rows(oriented)
    moved = _unorient(new_rows).to(board.dtype)
    scores = row_scores.sum(dim=-1, dtype=torch.int32)
    changed = (new_rows != oriented).any(dim=-1).any(dim=-1)
    return moved, scores, changed


def _select_direction(moved, scores, changed, action):
    """Pick direction ``action (...,)`` out of :func:`move_all`'s products."""
    sel = torch.arange(4, device=action.device) == action[..., None]
    board_after = torch.where(sel[..., None, None], moved,
                              torch.zeros_like(moved)).sum(
        dim=-3, dtype=moved.dtype)
    move_score = torch.where(sel, scores, torch.zeros_like(scores)).sum(
        dim=-1, dtype=torch.int32)
    legal = (changed & sel).any(dim=-1)
    return board_after, move_score, legal


def apply_action(
    board: torch.Tensor, action: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply ``action (...,)``; returns ``(new_board, merge_score, legal)``.

    An illegal move leaves the board unchanged with score 0
    (``rules.apply_action``).
    """
    moved, scores, changed = move_all(board)
    new_board, score, legal = _select_direction(moved, scores, changed,
                                                action)
    return (torch.where(legal[..., None, None], new_board, board),
            torch.where(legal, score, torch.zeros_like(score)), legal)


def is_dead(board: torch.Tensor) -> torch.Tensor:
    """True iff no direction is legal: no empty cell and no equal neighbours."""
    has_empty = (board == 0).flatten(-2).any(dim=-1)
    h = (board[..., :, :-1] == board[..., :, 1:]).flatten(-2).any(dim=-1)
    v = (board[..., :-1, :] == board[..., 1:, :]).flatten(-2).any(dim=-1)
    return ~(has_empty | h | v)


def highest(board: torch.Tensor) -> torch.Tensor:
    """Highest tile *value* per board as int32 (0 for an empty board)."""
    e = board.flatten(-2).amax(dim=-1).to(torch.int32)
    return torch.where(e > 0, _shl1(e), torch.zeros_like(e))


def count_empty(board: torch.Tensor) -> torch.Tensor:
    """Number of empty cells per board, int32."""
    return (board == 0).flatten(-2).sum(dim=-1, dtype=torch.int32)


def spawn(board: torch.Tensor, u_val: torch.Tensor,
          u_pos: torch.Tensor) -> torch.Tensor:
    """Spawn exponent 1 (``u_val < 0.9``) or 2 on one empty cell per board.

    ``u_val`` and ``u_pos`` are ``(...,)`` float32 uniforms in [0, 1). The
    tile goes to the ``k``-th empty cell in row-major order with
    ``k = min(trunc(u_pos * n_empty), n_empty - 1)``, the f32 law of
    ``rules.spawn``. A full board is left unchanged.
    """
    flat = board.flatten(-2)
    empty = flat == 0
    n_empty = empty.sum(dim=-1, dtype=torch.int32)
    k = torch.minimum((u_pos * n_empty).to(torch.int32), n_empty - 1)
    csum = torch.cumsum(empty, dim=-1, dtype=torch.int32)
    target = empty & (csum == (k + 1)[..., None])
    val = torch.where(u_val < 0.9, 1, 2).to(board.dtype)
    return (flat + target.to(board.dtype) * val[..., None]).reshape(
        board.shape)


def spawn_ranked(board: torch.Tensor, val_exp: torch.Tensor,
                 rank: torch.Tensor) -> torch.Tensor:
    """Parity-mode spawn: ``val_exp (...,)`` at the empty cell of least rank.

    ``rank (..., 16)`` is a permutation of 0..15 per board: the order in
    which the reference's shuffled position list visits the flat cells
    (``rules.spawn_ranked``). A full board is left unchanged.
    """
    flat = board.flatten(-2)
    empty = flat == 0
    masked = torch.where(empty, rank.to(torch.int32),
                         torch.full_like(rank, 100, dtype=torch.int32))
    pos = masked.argmin(dim=-1)
    add = torch.where(empty.any(dim=-1), val_exp.to(board.dtype),
                      torch.zeros_like(val_exp, dtype=board.dtype))
    cells = torch.arange(16, device=board.device)
    onehot = (cells == pos[..., None]).to(board.dtype)
    return (flat + onehot * add[..., None]).reshape(board.shape)


def exp_to_value(board: torch.Tensor) -> torch.Tensor:
    """Exponent boards -> tile-value boards (int32); 0 stays 0."""
    e = board.to(torch.int32)
    return torch.where(e > 0, _shl1(e), torch.zeros_like(e))


def value_to_exp(values: torch.Tensor) -> torch.Tensor:
    """Tile-value boards (powers of two, 0 = empty) -> int8 exponent boards."""
    v = values.to(torch.float32).clamp_min(1.0)
    return torch.round(torch.log2(v)).to(BOARD_DTYPE)
