"""The port's numpy rules (gym2048_tpu_torch.core.rules_np, a copy) against
the JAX package's (gym2048_tpu.core.rules_np): equal on every input, on
hypothesis-drawn rows and boards and on seeded random boards; the port's
``move_batch`` equal to ``move`` board by board.

Every function here is integer arithmetic, so every comparison is exact.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gym2048_tpu.core import rules_np as jrules_np
from gym2048_tpu_torch.core import rules_np

TILES = st.sampled_from([0, 0, 0, 2, 4, 8, 16, 32, 1024, 2048, 32768, 65536, 131072])
ROWS = st.lists(st.lists(TILES, min_size=4, max_size=4), min_size=1, max_size=8)
BOARDS = st.lists(st.lists(TILES, min_size=4, max_size=4), min_size=4, max_size=4)
FAST = settings(max_examples=150, deadline=None, derandomize=True)


def seeded_boards(n, seed, max_exp=17, p_zero=0.35):
    rng = np.random.default_rng(seed)
    e = rng.integers(1, max_exp + 1, size=(n, 4, 4))
    e = np.where(rng.random((n, 4, 4)) < p_zero, 0, e)
    return np.where(e > 0, np.left_shift(1, e), 0)


def dead_board():
    return np.array([[2, 4, 8, 16], [4, 8, 16, 2], [8, 16, 2, 4], [16, 2, 4, 8]])


@FAST
@given(ROWS)
def test_shift_rows_left_matches_jax(rows):
    got, want = rules_np.shift_rows_left(np.array(rows)), jrules_np.shift_rows_left(np.array(rows))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for row in rows:
        assert rules_np.shift_row_left(row) == jrules_np.shift_row_left(row)


@FAST
@given(BOARDS, st.integers(0, 3))
def test_move_legal_mask_is_dead_match_jax(board, direction):
    board = np.array(board)
    got, want = rules_np.move(board, direction), jrules_np.move(board, direction)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(rules_np.legal_mask(board), jrules_np.legal_mask(board))
    assert rules_np.is_dead(board) == jrules_np.is_dead(board)


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_boards_match_jax(seed):
    boards = seeded_boards(300, seed)
    boards[:3] = dead_board()
    boards[3] = 0
    for b in boards:
        for d in range(4):
            got, want = rules_np.move(b, d), jrules_np.move(b, d)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        np.testing.assert_array_equal(rules_np.legal_mask(b), jrules_np.legal_mask(b))
        assert rules_np.is_dead(b) == jrules_np.is_dead(b)
    assert rules_np.is_dead(boards[0]) and not rules_np.is_dead(boards[3])


def test_move_batch_equals_move_board_by_board():
    boards = seeded_boards(1000, 2)
    boards[:4] = dead_board()
    directions = np.random.default_rng(3).integers(0, 4, len(boards))
    new, scores, changed = rules_np.move_batch(boards, directions)
    assert new.shape == boards.shape and scores.shape == changed.shape == (len(boards),)
    for i, (b, d) in enumerate(zip(boards, directions)):
        want = jrules_np.move(b, int(d))
        np.testing.assert_array_equal(new[i], want[0])
        assert (scores[i], changed[i]) == want[1:]
    assert not changed[:4].any() and changed.any()
