"""The step algorithm of the single-step CUDA kernels, mirrored in plain torch.

``gym2048_tpu_torch/csrc/fused_step.cu`` computes ``fused_move`` and
``fused_step_uniform`` without the four-direction move of the TPU kernel:

* legality of the four directions from the board's 24 adjacent pairs (a
  line moves toward its position 0 iff some adjacent pair, read in that
  order, is (empty, tile) or two equal tiles), with no board moved;
* one move per board: the board is brought into the frame where the move
  is a leftward shift of rows (a conditional transpose, then a conditional
  mirror), its rows are compacted by six conditional pulls and merged in
  one pass, and the frame is undone.

The CUDA kernel cannot run here, so this file mirrors its steps in torch,
select for select, and holds the mirror against the JAX package with
tolerance 0: the pair predicate over every line of exponents 0-17 against
the ``changed`` flags of ``rules.move_all``; the one-direction move against
``pallas_step.fused_move`` in interpret mode; the whole step against
``pallas_step.fused_step_uniform`` in interpret mode. What these tests
check exhaustively is the mirror, not the CUDA source: the kernels' own
code is held against the plain versions on the host by
``tests/test_torch_fused_step_host.py``, and on the card by chip_smoke.py.
The mirror lives here only; the port's plain versions
(``core/fused_step.py``) are unchanged. The last tests cover the board
families and the register arithmetic chip_smoke.py uses.
"""

import itertools
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.core import pallas_step, rules as jrules
from gym2048_tpu_torch.core import fused_step as fs

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repository's GPU check, importable without a GPU)

MAX_EXP = 17
ROW_PAIRS = [(4 * r + c, 4 * r + c + 1) for r in range(4) for c in range(3)]
COL_PAIRS = [(4 * r + c, 4 * r + c + 4) for r in range(3) for c in range(4)]


# ------------------------------------------------------------ the mirror
def pair_legal(cm: torch.Tensor) -> torch.Tensor:
    """``[4, B]`` bool legality (up, right, down, left) of ``[16, B]``
    boards from their adjacent pairs (``legal_from_pairs``)."""
    tile = cm != 0
    empty = ~tile

    def any_pair(pairs, pred):
        return torch.stack([pred(i, j) for i, j in pairs]).any(0)

    merge_row = any_pair(ROW_PAIRS, lambda i, j: tile[i] & (cm[i] == cm[j]))
    merge_col = any_pair(COL_PAIRS, lambda i, j: tile[i] & (cm[i] == cm[j]))
    return torch.stack([
        any_pair(COL_PAIRS, lambda i, j: empty[i] & tile[j]) | merge_col,  # up
        any_pair(ROW_PAIRS, lambda i, j: tile[i] & empty[j]) | merge_row,  # right
        any_pair(COL_PAIRS, lambda i, j: tile[i] & empty[j]) | merge_col,  # down
        any_pair(ROW_PAIRS, lambda i, j: empty[i] & tile[j]) | merge_row,  # left
    ])


def line_legal(lines: torch.Tensor) -> torch.Tensor:
    """Whether each ``(N, 4)`` line moves toward its position 0."""
    a, b = lines[:, :3], lines[:, 1:]
    return (((a == 0) & (b != 0)) | ((a != 0) & (a == b))).any(1)


def _swap_if(p, x, y):
    return torch.where(p, y, x), torch.where(p, x, y)


def _transpose(b, p):
    for r in range(4):
        for c in range(r + 1, 4):
            b[4 * r + c], b[4 * c + r] = _swap_if(p, b[4 * r + c], b[4 * c + r])


def _mirror(b, p):
    for r in range(4):
        b[4 * r], b[4 * r + 3] = _swap_if(p, b[4 * r], b[4 * r + 3])
        b[4 * r + 1], b[4 * r + 2] = _swap_if(p, b[4 * r + 1], b[4 * r + 2])


def to_line_frame(cm: torch.Tensor, d: torch.Tensor) -> list:
    """Rows of the frame where direction ``d [B]`` moves leftward."""
    b = list(cm)
    _transpose(b, (d & 1) == 0)
    _mirror(b, (d == 1) | (d == 2))
    return b


def from_line_frame(b: list, d: torch.Tensor) -> torch.Tensor:
    b = list(b)
    _mirror(b, (d == 1) | (d == 2))
    _transpose(b, (d & 1) == 0)
    return torch.stack(b)


def _pull(x, y):
    e = x == 0
    return torch.where(e, y, x), torch.where(e, 0, y)


def slide_line(a0, a1, a2, a3):
    """``slide_line``: compact by six pulls, merge in one pass. Returns the
    new line, its merge score and whether it changed."""
    c0, c1, c2, c3 = a0, a1, a2, a3
    c0, c1 = _pull(c0, c1)
    c1, c2 = _pull(c1, c2)
    c2, c3 = _pull(c2, c3)
    c0, c1 = _pull(c0, c1)
    c1, c2 = _pull(c1, c2)
    c0, c1 = _pull(c0, c1)
    m01 = (c0 != 0) & (c0 == c1)
    m12 = (c1 != 0) & (c1 == c2) & ~m01
    m23 = (c2 != 0) & (c2 == c3) & ~m12
    i01, i12, i23 = (m.to(torch.int32) for m in (m01, m12, m23))
    o0 = c0 + i01
    o1 = torch.where(m01, c2 + i23, c1 + i12)
    o2 = torch.where(m01, torch.where(m23, 0, c3), torch.where(m12, c3, c2 + i23))
    o3 = torch.where(m01 | m12 | m23, 0, c3)
    score = (torch.where(m01, 1 << (c0 + 1), 0) + torch.where(m12, 1 << (c1 + 1), 0)
             + torch.where(m23, 1 << (c2 + 1), 0))
    changed = (o0 != a0) | (o1 != a1) | (o2 != a2) | (o3 != a3)
    return (o0, o1, o2, o3), score, changed


def move_one(cm: torch.Tensor, d: torch.Tensor):
    """``move_one`` on ``[16, B]`` boards: moved boards, merge score, changed."""
    b = to_line_frame(cm, d)
    score = torch.zeros_like(d)
    changed = torch.zeros(cm.shape[1], dtype=torch.bool)
    for l in range(4):
        line, s, ch = slide_line(*b[4 * l:4 * l + 4])
        b[4 * l:4 * l + 4] = line
        score, changed = score + s, changed | ch
    return from_line_frame(b, d), score, changed


def step_one(cm: torch.Tensor, u: torch.Tensor, max_tile_exp: int):
    """``fused_step_uniform_kernel``: legality from pairs, the r-th legal
    direction, one move, the spawn, the win test and the reset."""
    legal = pair_legal(cm).to(torch.int32)
    n_legal = legal.sum(0)
    r = (u[0] * n_legal.to(torch.float32)).to(torch.int32)
    r = torch.minimum(r, torch.clamp(n_legal - 1, min=0))
    action, cum = torch.zeros_like(n_legal), torch.zeros_like(n_legal)
    for d in range(4):
        action = torch.where((legal[d] == 1) & (cum == r), d, action)
        cum = cum + legal[d]
    moved, score, _ = move_one(cm, action)
    board = fs._spawn_cm(moved, u[1], u[2])
    won = (board == max_tile_exp).any(0) if max_tile_exp > 0 else torch.zeros_like(n_legal, dtype=torch.bool)
    finish = (n_legal == 0) | won
    fresh = fs._spawn_cm(fs._spawn_cm(torch.zeros_like(cm), u[1], u[2]), u[3], u[4])
    board = torch.where(finish[None, :], fresh, board)
    return (board, torch.where(finish, 0.0, score.to(torch.float32)),
            finish.to(torch.int32), action)


# ------------------------------------------------------------ inputs
def all_lines() -> np.ndarray:
    """Every line of exponents 0-17: 18^4 = 104,976 rows of 4."""
    return np.array(list(itertools.product(range(MAX_EXP + 1), repeat=4)), np.int32)


def embedded(lines: np.ndarray, where: str) -> np.ndarray:
    """``(N, 4, 4)`` boards holding each line in row 0 or in column 0."""
    boards = np.zeros((lines.shape[0], 4, 4), np.int32)
    if where == "row":
        boards[:, 0, :] = lines
    else:
        boards[:, :, 0] = lines
    return boards


def jax_changed(boards: np.ndarray) -> np.ndarray:
    """``[4, N]`` changed flags of JAX ``rules.move_all``."""
    return np.asarray(jax.jit(jax.vmap(jrules.move_all))(jnp.asarray(boards))[2]).T


def cell_major(boards: np.ndarray) -> torch.Tensor:
    return fs.to_cell_major(torch.as_tensor(np.asarray(boards)))


def step_boards(n: int, seed: int) -> np.ndarray:
    return chip_smoke.adversarial_boards(np.random.default_rng(seed), n)[0]


# ------------------------------------------------------------ legality
@pytest.mark.parametrize("where", ["row", "column"])
def test_pair_legality_exhaustive_over_lines(where):
    """Every line of exponents 0-17, in a row and in a column of an
    otherwise empty board: the pair predicate gives the ``changed`` flags
    of JAX ``move_all`` in all four directions."""
    lines = all_lines()
    boards = embedded(lines, where)
    want = jax_changed(boards)
    got = pair_legal(cell_major(boards)).numpy()
    np.testing.assert_array_equal(got, want)
    # the line itself, read from position 0 and mirrored
    forward, backward = (3, 1) if where == "row" else (0, 2)
    t = torch.as_tensor(lines)
    np.testing.assert_array_equal(line_legal(t).numpy(), want[forward])
    np.testing.assert_array_equal(line_legal(t.flip(1)).numpy(), want[backward])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_legality_on_whole_boards(seed):
    boards = step_boards(8192, seed)
    np.testing.assert_array_equal(pair_legal(cell_major(boards)).numpy(),
                                  jax_changed(boards))


# ------------------------------------------------------------ one move
def test_line_frame_is_the_rollouts_cell_map():
    """Row l, position k of direction d's frame is ``cell(d, l, k)``, and
    the frame is undone exactly."""
    cm = torch.arange(16, dtype=torch.int32)[:, None].repeat(1, 4)
    d = torch.arange(4, dtype=torch.int32)
    frame = torch.stack(to_line_frame(cm, d))
    for dd in range(4):
        want = [fs._cell(dd, l, k) for l in range(4) for k in range(4)]
        assert frame[:, dd].tolist() == want
    assert torch.equal(from_line_frame(list(frame), d), cm)


def test_slide_line_exhaustive_over_lines():
    """Every line of exponents 0-17 against JAX ``_compact_merge_rows``."""
    lines = all_lines()
    want_rows, want_score = jax.jit(jrules._compact_merge_rows)(jnp.asarray(lines))
    t = torch.as_tensor(lines)
    got, score, changed = slide_line(*t.T)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(score.numpy(), np.asarray(want_score))
    np.testing.assert_array_equal(changed.numpy(), (np.asarray(want_rows) != lines).any(1))


@pytest.mark.parametrize("action", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_move_matches_pallas_fused_move(seed, action):
    """One direction per board in the leftward frame against the Pallas
    kernel in interpret mode (as tests/test_torch_fused_step.py runs it):
    seeded boards of exponents 0-17, tolerance 0."""
    n = 512
    rng = np.random.default_rng(seed)
    boards = np.where(rng.random((n, 4, 4)) < 0.35, 0,
                      rng.integers(0, MAX_EXP + 1, (n, 4, 4))).astype(np.int32)
    act = np.full(n, action, np.int32)
    ref = pallas_step.fused_move(pallas_step.to_cell_major(jnp.asarray(boards)),
                                 jnp.asarray(act), 512, True)
    moved, score, changed = move_one(cell_major(boards), torch.as_tensor(act))
    np.testing.assert_array_equal(moved.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(score.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(changed.numpy().astype(np.int32), np.asarray(ref[2]))


def test_one_move_on_board_families_matches_pallas():
    """The families of chip_smoke.py (dead, merge-only, one legal
    direction, exponents 15-17, ...) with mixed actions in one batch."""
    n = 1024
    boards = step_boards(n, 7)
    act = np.random.default_rng(7).integers(0, 4, n).astype(np.int32)
    ref = pallas_step.fused_move(pallas_step.to_cell_major(jnp.asarray(boards)),
                                 jnp.asarray(act), 1024, True)
    got = move_one(cell_major(boards), torch.as_tensor(act))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy().astype(np.int32), np.asarray(r))


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("max_tile_exp", [0, 2, 11, 17])
def test_step_matches_pallas_fused_step_uniform(max_tile_exp):
    """The whole step (legality from pairs, action, one move, spawn, win,
    reset) against the Pallas kernel in interpret mode, tolerance 0."""
    n = 1024
    boards = step_boards(n, max_tile_exp)
    u = np.random.default_rng(100 + max_tile_exp).random((8, n)).astype(np.float32)
    ref = pallas_step.fused_step_uniform(pallas_step.to_cell_major(jnp.asarray(boards)),
                                         jnp.asarray(u), 1024, max_tile_exp, True)
    got = step_one(cell_major(boards), torch.as_tensor(u), max_tile_exp)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_array_equal(g.numpy().astype(r.dtype), r)
    finished = got[2].numpy() == 1
    assert finished.any() and not finished.all()


# ------------------------------------------------------------ chip_smoke's inputs
def test_board_families_are_what_they_claim():
    boards, family = chip_smoke.adversarial_boards(np.random.default_rng(3), 4096)
    assert boards.shape == (4096, 4, 4) and family.shape == (4096,)
    assert np.bincount(family).tolist() == [512] * 8
    legal = jax_changed(boards.astype(np.int32))
    n_legal = legal.sum(0)
    fam = {name: family == i for i, name in enumerate(chip_smoke.BOARD_FAMILIES)}
    full = (boards != 0).all((1, 2))
    assert (n_legal[fam["dead"]] == 0).all() and full[fam["dead"]].all()
    assert full[fam["full, merge only"]].all() and (n_legal[fam["full, merge only"]] > 0).all()
    assert (n_legal[fam["one legal direction"]] == 1).all()
    assert set(legal[:, fam["one legal direction"]].argmax(0).tolist()) == {0, 1, 2, 3}
    assert boards[fam["exponents 15-17"]].max() == 17
    assert not np.isin(boards[fam["no 1 or 2"]], [1, 2]).any()


RES_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN46_GLOBAL__N__71f402d8_13_fused_step_cu_22b194e817fused_move_kernelEPKiS1_PiS2_S2_x:
  REG:54 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:568 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN46_GLOBAL__N__71f402d8_13_fused_step_cu_22b194e825fused_step_uniform_kernelEPKiPKfPiPfS4_S4_xi:
  REG:64 STACK:16 SHARED:0 LOCAL:0 CONSTANT[0]:572 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_ptxas_report_and_occupancy():
    """The registers ptxas gave each kernel, read from ``cuobjdump
    -res-usage``; chip_smoke.py's block sizes are those of the launchers;
    and the CUDA occupancy rules."""
    usage = chip_smoke.resource_usage(RES_USAGE)
    assert {k: (u["REG"], u["STACK"]) for k, u in usage.items()} == {
        "fused_move_kernel": (54, 0), "fused_step_uniform_kernel": (64, 16)}
    assert usage["fused_move_kernel"]["CONSTANT[0]"] == 568
    source = (ROOT / "gym2048_tpu_torch/csrc/fused_step.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", source))
    launched = dict(re.findall(r"(\w+)_kernel<<<grid_for\([^;]*?\), (\w+),", source))
    assert {name: int(consts[launched[name]]) for name in chip_smoke.BLOCK_THREADS} == \
        chip_smoke.BLOCK_THREADS
    # 65,536 registers an SM, 256 a unit per warp, 64 warps, 32 blocks
    assert [chip_smoke.blocks_per_sm(r, t) for r, t in
            [(38, 128), (54, 128), (64, 128), (101, 256), (123, 256), (24, 32)]] == [
                12, 9, 8, 2, 2, 32]
