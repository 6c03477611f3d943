"""NumPy mirror of the 2048 rules — the host-side / parity oracle (a copy
of ``gym2048_tpu/core/rules_np.py``, which cannot be imported without JAX,
plus :func:`move_batch`).

Same semantics as :mod:`gym2048_tpu_torch.core.rules` but on **tile-value** boards
(0, 2, 4, ...) like the reference env exposes via ``get_board``/``set_board``
(game2048_env.py:282-288). Used by the Gymnasium single-env adapter (which
must be cheap to call once per step on host) and as an independent oracle for
differential testing against the device rules.

The implementation is the same branch-free dataflow as the JAX version, so
both engines share one algorithm reviewed in one place; the reference's
list-based single-pass loop (game2048_env.py:243-260) is reproduced
semantically, not structurally.
"""

from __future__ import annotations

import numpy as np


def shift_rows_left(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Compact + single-pass merge of value rows, leftward.

    Args:
        rows: ``(N, 4)`` int array of tile values (0 = empty).

    Returns:
        ``(new_rows (N, 4), scores (N,))``.
    """
    rows = np.asarray(rows, dtype=np.int64)
    a = [rows[:, i] for i in range(4)]

    # Stable compaction: nonzero cell j lands at slot (#nonzero before j).
    nz = [(x != 0).astype(np.int64) for x in a]
    pos = [np.zeros_like(nz[0]), nz[0], nz[0] + nz[1], nz[0] + nz[1] + nz[2]]
    c = []
    for k in range(4):
        slot = np.zeros_like(a[0])
        for j in range(k, 4):
            slot = np.where((nz[j] == 1) & (pos[j] == k), a[j], slot)
        c.append(slot)
    c0, c1, c2, c3 = c

    m01 = (c0 != 0) & (c0 == c1)
    m12 = (c1 != 0) & (c1 == c2) & ~m01
    m23 = (c2 != 0) & (c2 == c3) & ~m12
    i01, i12, i23 = (m.astype(np.int64) for m in (m01, m12, m23))

    out0 = c0 * (1 + i01)
    out1 = np.where(m01, c2 * (1 + i23), c1 * (1 + i12))
    out2 = np.where(m01, np.where(m23, 0, c3), np.where(m12, c3, c2 * (1 + i23)))
    out3 = np.where(m01 | m12 | m23, 0, c3)

    score = i01 * 2 * c0 + i12 * 2 * c1 + i23 * 2 * c2
    return np.stack([out0, out1, out2, out3], axis=1), score


def shift_row_left(row) -> tuple[list, int]:
    """Single-row convenience wrapper; mirrors the reference ``shift`` API."""
    new, score = shift_rows_left(np.asarray(row, dtype=np.int64)[None])
    return new[0].tolist(), int(score[0])


def move(board: np.ndarray, direction: int) -> tuple[np.ndarray, int, bool]:
    """Apply one move to a ``(4, 4)`` value board.

    Direction 0=up 1=right 2=down 3=left (reference game2048_env.py:49).

    Returns:
        ``(new_board, merge_score, changed)`` — ``new_board`` equals the input
        when the move is illegal (``changed`` False).
    """
    board = np.asarray(board, dtype=np.int64)
    if direction == 0:  # up: columns shifted toward row 0
        lines = board.T
    elif direction == 1:  # right: rows reversed
        lines = board[:, ::-1]
    elif direction == 2:  # down: columns reversed
        lines = board.T[:, ::-1]
    else:  # left
        lines = board
    new_lines, scores = shift_rows_left(lines)
    if direction == 0:
        new_board = new_lines.T
    elif direction == 1:
        new_board = new_lines[:, ::-1]
    elif direction == 2:
        new_board = new_lines[:, ::-1].T
    else:
        new_board = new_lines
    changed = bool((new_board != board).any())
    return (new_board if changed else board), int(scores.sum()), changed


def legal_mask(board: np.ndarray) -> np.ndarray:
    """``(4,)`` bool — which directions change the board."""
    return np.array([move(board, d)[2] for d in range(4)])


def is_dead(board: np.ndarray) -> bool:
    """No legal move: board full and no equal adjacent pair."""
    board = np.asarray(board)
    if (board == 0).any():
        return False
    if (board[:, :-1] == board[:, 1:]).any():
        return False
    if (board[:-1, :] == board[1:, :]).any():
        return False
    return True


def move_batch(boards: np.ndarray, directions: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`move` of each ``(4, 4)`` board of ``boards (N, 4, 4)`` in its
    own direction of ``directions (N,)``, in one :func:`shift_rows_left`
    per direction. Returns ``(new_boards (N, 4, 4), scores (N,), changed
    (N,))``; a board whose move is illegal comes back unchanged."""
    boards = np.asarray(boards, dtype=np.int64)
    directions = np.asarray(directions).reshape(-1)
    new = boards.copy()
    scores = np.zeros(len(boards), np.int64)
    # each direction as a view whose rows shift leftward, and its inverse
    views = {0: (lambda b: b.transpose(0, 2, 1), lambda b: b.transpose(0, 2, 1)),
             1: (lambda b: b[:, :, ::-1], lambda b: b[:, :, ::-1]),
             2: (lambda b: b.transpose(0, 2, 1)[:, :, ::-1],
                 lambda b: b[:, :, ::-1].transpose(0, 2, 1)),
             3: (lambda b: b, lambda b: b)}
    for d, (to_rows, from_rows) in views.items():
        sel = np.nonzero(directions == d)[0]
        if not len(sel):
            continue
        lines, line_scores = shift_rows_left(to_rows(boards[sel]).reshape(-1, 4))
        new[sel] = from_rows(lines.reshape(-1, 4, 4))
        scores[sel] = line_scores.reshape(-1, 4).sum(1)
    changed = (new != boards).any(axis=(1, 2))
    return new, scores, changed
