"""Fused 2048 step kernels for the GPU, with their plain PyTorch versions.

Counterpart of ``gym2048_tpu/core/pallas_step.py`` (the Pallas TPU kernels).
The CUDA source is ``gym2048_tpu_torch/csrc/fused_step.cu``; it is compiled
at the first launch by :mod:`gym2048_tpu_torch._build`.

Layout: boards are cell-major ``[16, B]`` int32, as in the JAX module
(:func:`to_cell_major`). Each wrapper

* checks dtype, shape and contiguity, then
* runs the plain version (``*_reference``) when its tensors lie on the CPU,
* and otherwise launches the CUDA kernel on the current stream, raising on
  any build or launch failure. There is no fallback from a CUDA tensor to
  the plain version.

``LAUNCHES`` counts the kernel launches per wrapper.

Random numbers: the TPU kernel draws from the TPU's own PRNG, whose bits
cannot be reproduced. The rollout here uses Philox4x32-10 with key
``(seed, 0)`` and counter ``(board, step, j, 0)``; ``j = 0, 1`` give the
eight words of one step, turned into uniforms in [0, 1) as
``(word >> 8) * 2**-24`` (``pallas_step._random_uniform_rows``). Uniform row
``r`` of a step is word ``r % 4`` of ``j = r // 4``: row 0 picks the action,
rows 1-2 place the spawn (position, value) and rows 3-4 the second tile of a
reset. The plain Philox below splits each 32x32-bit product into 16-bit
halves so that int64 never overflows, which keeps kernel and plain version
equal bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from gym2048_tpu_torch.core import rules

LAUNCHES = {
    "fused_move": 0,
    "fused_step_uniform": 0,
    "fused_rollout": 0,
    "random_uniform_rows": 0,
    "philox4x32": 0,
}

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _cell(direction: int, line: int, k: int) -> int:
    """Cell of (direction, line, position in line); every move becomes a
    leftward shift of the positions (``pallas_step._cell``)."""
    if direction == 0:  # up: columns top->bottom
        return 4 * k + line
    if direction == 1:  # right: rows right->left
        return 4 * line + (3 - k)
    if direction == 2:  # down: columns bottom->top
        return 4 * (3 - k) + line
    return 4 * line + k  # left: rows left->right


# Row 16 * k + 4 * d + l of the gathered board is the cell at position k of
# line l of direction d; _UNSHIFT[d][cell] is the row that goes back to cell.
_LINE_CELLS = [_cell(d, l, k) for k in range(4) for d in range(4)
               for l in range(4)]
_UNSHIFT = [[0] * 16 for _ in range(4)]
for _d in range(4):
    for _l in range(4):
        for _k in range(4):
            _UNSHIFT[_d][_cell(_d, _l, _k)] = 16 * _k + 4 * _d + _l


# ------------------------------------------------------------ layout
def to_cell_major(boards: torch.Tensor) -> torch.Tensor:
    """``(B, 4, 4)`` exponent boards -> ``[16, B]`` int32 cell-major."""
    return boards.reshape(boards.shape[0], 16).to(torch.int32).T.contiguous()


def from_cell_major(boards_cm: torch.Tensor) -> torch.Tensor:
    """``[16, B]`` cell-major -> ``(B, 4, 4)`` int8 boards."""
    return boards_cm.T.reshape(-1, 4, 4).to(torch.int8)


# ------------------------------------------------------------ plain versions
def _select4(values, table):
    """Per-board pick from 4 candidates by ``values``: 0, 1, 2, else 3."""
    return torch.where(values == 0, table[0],
           torch.where(values == 1, table[1],
           torch.where(values == 2, table[2], table[3])))


def _compute_moves(board: torch.Tensor):
    """All-directions compact and merge of ``[16, B]`` int32 boards.

    Returns the shifted line positions ``outs`` (4 tensors ``[16 (4d+l), B]``),
    ``legal_dir`` (4 ``[B]`` bool) and ``score_dir`` (4 ``[B]`` int32)."""
    n = board.shape[1]
    lines = board.index_select(
        0, torch.tensor(_LINE_CELLS, device=board.device))
    rows = lines.reshape(4, 16, n).permute(1, 2, 0)  # [16 (4d+l), B, 4 (k)]
    new, row_score = rules._compact_merge_rows(rows)
    outs = [new[..., k] for k in range(4)]
    changed = (new != rows).to(torch.int32).sum(dim=-1) > 0
    legal_dir = [changed[4 * d] | changed[4 * d + 1] | changed[4 * d + 2]
                 | changed[4 * d + 3] for d in range(4)]
    score_dir = [row_score[4 * d:4 * d + 4].sum(dim=0, dtype=torch.int32)
                 for d in range(4)]
    return outs, legal_dir, score_dir


def _apply_action(outs, action: torch.Tensor) -> torch.Tensor:
    """The moved ``[16, B]`` board of direction ``action`` per board."""
    shifted = torch.cat(outs)
    unshift = torch.tensor(_UNSHIFT, device=shifted.device)
    moved_dir = [shifted.index_select(0, unshift[d]) for d in range(4)]
    return _select4(action[None, :], moved_dir)


def _spawn_cm(bd: torch.Tensor, u_p: torch.Tensor, u_v: torch.Tensor) -> torch.Tensor:
    """Spawn exponent 1 (``u_v < 0.9``) or 2 at the ``floor(u_p * n_empty)``-th
    empty cell (clamped) of ``[16, B]`` boards; no-op when full
    (``pallas_step._spawn_cm``: position first, then value)."""
    empty = bd == 0
    csum = torch.cumsum(empty, dim=0, dtype=torch.int32).to(torch.float32)
    n_empty = csum[15]
    k = torch.floor(u_p * n_empty)
    k = torch.minimum(k, torch.clamp(n_empty - 1.0, min=0.0))
    target = empty & (csum == (k + 1.0)[None, :])
    val = torch.where(u_v < 0.9, 1, 2).to(torch.int32)
    return bd + target.to(torch.int32) * val[None, :]


def _step_cm(board, score, episodes, total_score, u, max_tile_exp: int):
    """One random-legal step with auto-reset on ``[16, B]`` boards, uniforms
    ``u [>=5, B]`` (``pallas_step._step_cm``). Returns ``(board, score,
    episodes, total_score, action)``."""
    u_act, u_pos, u_val, u_pos2, u_val2 = u[0], u[1], u[2], u[3], u[4]
    outs, legal_dir, score_dir = _compute_moves(board)
    legal_i = [x.to(torch.int32) for x in legal_dir]
    n_legal = legal_i[0] + legal_i[1] + legal_i[2] + legal_i[3]
    dead = n_legal == 0

    # the r-th legal direction: exactly one d has legal & (cum == r)
    r = (u_act * n_legal.to(torch.float32)).to(torch.int32)
    r = torch.minimum(r, torch.clamp(n_legal - 1, min=0))
    cum = torch.zeros_like(n_legal)
    action = torch.zeros_like(n_legal)
    for d in range(4):
        action = torch.where(legal_dir[d] & (cum == r), d, action)
        cum = cum + legal_i[d]
    move_score = _select4(action, score_dir)

    stepped = _spawn_cm(_apply_action(outs, action), u_pos, u_val)
    if max_tile_exp > 0:
        finish = dead | ((stepped == max_tile_exp).sum(dim=0) > 0)
    else:
        finish = dead
    fresh = _spawn_cm(_spawn_cm(torch.zeros_like(board), u_pos, u_val),
                      u_pos2, u_val2)
    # a dead board took no move (stepped == board, move_score == 0)
    new_board = torch.where(finish[None, :], fresh, stepped)
    gained = move_score.to(torch.float32)
    new_score = torch.where(finish, 0.0, score + gained)
    return (new_board, new_score, episodes + finish.to(torch.int32),
            total_score + gained, action)


def _mulhilo32(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``m * x`` for uint32 values held in int64,
    from 16-bit halves so that no intermediate exceeds 2**34."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = ml * xh + mh * xl
    low = ml * xl + ((mid & 0xFFFF) << 16)
    hi = mh * xh + (mid >> 16) + (low >> 32)
    return hi, low & _MASK32


def philox4x32_reference(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of ``counter (N, 4)`` under ``key (N, 2)``: ``(N, 4)``
    int64 tensor of uint32 words (Random123's ``philox4x32``)."""
    c0, c1, c2, c3 = (counter[:, i].to(torch.int64) & _MASK32 for i in range(4))
    k0, k1 = (key[:, i].to(torch.int64) & _MASK32 for i in range(2))
    for rnd in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if rnd < 9:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=1)


def _uniform_from_words(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 uniforms ``(w >> 8) * 2**-24``."""
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _philox_uniforms(seed: int, boards: torch.Tensor, step: int) -> torch.Tensor:
    """The 8 uniform rows of one step, ``[8, len(boards)]``: row ``r`` is word
    ``r % 4`` of counter ``(board, step, r // 4, 0)`` under key ``(seed, 0)``."""
    n = boards.shape[0]
    both = torch.cat([boards, boards])
    j = torch.cat([torch.zeros_like(boards), torch.ones_like(boards)])
    counter = torch.stack([both, torch.full_like(both, step), j,
                           torch.zeros_like(both)], dim=1)
    key = torch.stack([torch.full_like(both, seed & _MASK32),
                       torch.zeros_like(both)], dim=1)
    words = philox4x32_reference(counter, key)  # (2n, 4)
    return _uniform_from_words(words.reshape(2, n, 4).permute(0, 2, 1)
                               ).reshape(8, n)


def fused_move_reference(boards_cm: torch.Tensor, actions: torch.Tensor):
    """Plain version of :func:`fused_move`."""
    outs, legal_dir, score_dir = _compute_moves(boards_cm)
    moved = _apply_action(outs, actions)
    legal = _select4(actions, [x.to(torch.int32) for x in legal_dir])
    out = torch.where(legal[None, :] == 1, moved, boards_cm)
    return out, _select4(actions, score_dir) * legal, legal


def fused_step_uniform_reference(boards_cm: torch.Tensor, u: torch.Tensor,
                                 max_tile_exp: int = 0):
    """Plain version of :func:`fused_step_uniform`."""
    n = boards_cm.shape[1]
    zero_f = torch.zeros(n, dtype=torch.float32, device=boards_cm.device)
    zero_i = torch.zeros(n, dtype=torch.int32, device=boards_cm.device)
    board, score, episodes, _, action = _step_cm(
        boards_cm, zero_f, zero_i, zero_f, u, max_tile_exp)
    return board, score, episodes, action


def fused_rollout_reference(boards_cm: torch.Tensor, seed: int, steps: int,
                            max_tile_exp: int = 0):
    """Plain version of :func:`fused_rollout`, drawing the same Philox words."""
    n = boards_cm.shape[1]
    device = boards_cm.device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    board = boards_cm
    score = torch.zeros(n, dtype=torch.float32, device=device)
    total = torch.zeros(n, dtype=torch.float32, device=device)
    episodes = torch.zeros(n, dtype=torch.int32, device=device)
    for t in range(steps):
        u = _philox_uniforms(seed, idx, t)
        board, score, episodes, total, _ = _step_cm(
            board, score, episodes, total, u, max_tile_exp)
    return board, score, episodes, total


def random_uniform_rows_reference(seed: int, shape: tuple[int, int],
                                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Plain version of :func:`random_uniform_rows`."""
    rows, cols = shape
    groups = (rows + 3) // 4
    c = torch.arange(cols, dtype=torch.int64, device=device)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    gg, cc = torch.meshgrid(g, c, indexing="ij")
    counter = torch.stack([cc.reshape(-1), (gg // 2).reshape(-1),
                           (gg % 2).reshape(-1),
                           torch.zeros_like(cc).reshape(-1)], dim=1)
    key = torch.zeros((counter.shape[0], 2), dtype=torch.int64, device=device)
    key[:, 0] = seed & _MASK32
    u = _uniform_from_words(philox4x32_reference(counter, key))  # (G*C, 4)
    return u.reshape(groups, cols, 4).permute(0, 2, 1).reshape(
        groups * 4, cols)[:rows].contiguous()


# ------------------------------------------------------------ wrappers
def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} of shape {shape}, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_boards(boards_cm: torch.Tensor) -> int:
    if boards_cm.dim() != 2 or boards_cm.shape[0] != 16:
        raise ValueError(f"boards_cm must be [16, B], got {tuple(boards_cm.shape)}")
    n = boards_cm.shape[1]
    _check("boards_cm", boards_cm, torch.int32, (16, n), boards_cm.device)
    return n


def _check_block(n: int, block: int) -> None:
    block = min(block, n)
    if block <= 0 or n % block:
        raise ValueError(f"B={n} must be a positive multiple of block={block}")


def _launch(name: str, *args) -> None:
    """Call the C launcher ``gym_<name>`` on the current stream, check the
    ``cudaGetLastError`` code it returns, and count the launch."""
    from gym2048_tpu_torch import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"gym_{name}")(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.gym_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}; use cpu or cuda")


def fused_move(boards_cm: torch.Tensor, actions: torch.Tensor, block: int = 2048):
    """One move on ``[16, B]`` cell-major boards with given ``actions [B]``
    int32 (0..3; any other value acts as 3, as ``pallas_step._select4``).

    Returns ``(moved_cm [16, B] i32, scores [B] i32, legal [B] i32)``; an
    illegal move leaves the board unchanged with score 0
    (``pallas_step.fused_move``). ``block`` is there for the JAX signature:
    B must be a multiple of ``min(block, B)`` as there, but the launch
    does not depend on it (blocks of 256 threads, one board each)."""
    n = _check_boards(boards_cm)
    _check_block(n, block)
    _check("actions", actions, torch.int32, (n,), boards_cm.device)
    if boards_cm.device.type == "cpu":
        return fused_move_reference(boards_cm, actions)
    _require_cuda(boards_cm)
    with torch.cuda.device(boards_cm.device):
        out = torch.empty_like(boards_cm)
        score = torch.empty(n, dtype=torch.int32, device=boards_cm.device)
        legal = torch.empty(n, dtype=torch.int32, device=boards_cm.device)
        _launch("fused_move", _ptr(boards_cm), _ptr(actions), _ptr(out),
                _ptr(score), _ptr(legal), n)
    return out, score, legal


def fused_step_uniform(boards_cm: torch.Tensor, u: torch.Tensor,
                       block: int = 2048, max_tile_exp: int = 0):
    """One random-legal rollout step with caller-supplied uniforms
    ``u [8, B]`` float32 (rows 0-4 used), the same dataflow as one step of
    :func:`fused_rollout` (``pallas_step.fused_step_uniform``).

    Returns ``(new_board [16, B] i32, step_score [B] f32 (0 after a reset),
    finished [B] i32, action [B] i32)``; a dead board reports action 0.
    ``block`` is checked as in :func:`fused_move` and does not shape the
    launch."""
    n = _check_boards(boards_cm)
    _check_block(n, block)
    _check("u", u, torch.float32, (8, n), boards_cm.device)
    if boards_cm.device.type == "cpu":
        return fused_step_uniform_reference(boards_cm, u, max_tile_exp)
    _require_cuda(boards_cm)
    with torch.cuda.device(boards_cm.device):
        out = torch.empty_like(boards_cm)
        score = torch.empty(n, dtype=torch.float32, device=boards_cm.device)
        finished = torch.empty(n, dtype=torch.int32, device=boards_cm.device)
        action = torch.empty(n, dtype=torch.int32, device=boards_cm.device)
        _launch("fused_step_uniform", _ptr(boards_cm), _ptr(u), _ptr(out),
                _ptr(score), _ptr(finished), _ptr(action), n, max_tile_exp)
    return out, score, finished, action


def fused_rollout(boards_cm: torch.Tensor, seed: int, steps: int,
                  block: int = 2048, max_tile_exp: int = 0):
    """Run ``steps`` steps of random-legal self-play with auto-reset
    (``pallas_step.fused_rollout``). Dead boards, and with
    ``max_tile_exp > 0`` boards holding that tile, are reset with two spawns
    and counted as episodes.

    Args:
        boards_cm: ``[16, B]`` int32 cell-major boards; B must be a multiple
            of ``block`` and ``block`` a multiple of 128 (the JAX module's
            shape rule; the kernel itself takes any B).
        seed: Philox key; the uniforms of board b at step t come from
            counter ``(b, t, j, 0)``.
        steps: number of env steps.

    Returns:
        ``(boards_cm [16, B] i32, scores [B] f32, episodes [B] i32,
        total_scores [B] f32)``: final boards, current-episode scores,
        episodes completed and the total merge score per slot.
    """
    n = _check_boards(boards_cm)
    if block <= 0 or n % block or block % 128:
        raise ValueError(f"B={n} must be a multiple of block={block}, "
                         "itself a multiple of 128")
    seed, steps = int(seed), int(steps)
    if boards_cm.device.type == "cpu":
        return fused_rollout_reference(boards_cm, seed, steps, max_tile_exp)
    _require_cuda(boards_cm)
    with torch.cuda.device(boards_cm.device):
        out = torch.empty_like(boards_cm)
        score = torch.empty(n, dtype=torch.float32, device=boards_cm.device)
        episodes = torch.empty(n, dtype=torch.int32, device=boards_cm.device)
        total = torch.empty(n, dtype=torch.float32, device=boards_cm.device)
        _launch("fused_rollout", _ptr(boards_cm), ctypes.c_uint32(seed & _MASK32),
                steps, max_tile_exp, _ptr(out), _ptr(score), _ptr(episodes),
                _ptr(total), n)
    return out, score, episodes, total


def random_uniform_rows(seed: int, shape: tuple[int, int],
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """``shape = (rows, cols)`` float32 uniforms in [0, 1) from the rollout's
    generator: entry ``[r, c]`` is the uniform row ``r % 8`` that
    :func:`fused_rollout` draws for board ``c`` at step ``r // 8``.

    Counterpart of the statistics kernel of ``scripts/tpu_pallas_stats.py``
    around ``pallas_step._random_uniform_rows``."""
    rows, cols = (int(s) for s in shape)
    if rows <= 0 or cols <= 0:
        raise ValueError(f"shape must be positive, got {shape}")
    device = torch.device(device)
    if device.type == "cpu":
        return random_uniform_rows_reference(seed, (rows, cols), device)
    if device.type != "cuda":
        raise ValueError(f"no kernel for {device}; use cpu or cuda")
    with torch.cuda.device(device):
        out = torch.empty((rows, cols), dtype=torch.float32, device=device)
        _launch("random_uniform_rows", ctypes.c_uint32(int(seed) & _MASK32),
                _ptr(out), rows, cols)
    return out


def philox4x32(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 words of ``counter (N, 4)`` under ``key (N, 2)``, both
    int64 holding uint32 values; returns ``(N, 4)`` int64. The kernel runs
    the device function that the rollout draws from (a test surface)."""
    if counter.dim() != 2 or counter.shape[1] != 4:
        raise ValueError(f"counter must be (N, 4), got {tuple(counter.shape)}")
    n = counter.shape[0]
    _check("counter", counter, torch.int64, (n, 4), counter.device)
    _check("key", key, torch.int64, (n, 2), counter.device)
    if counter.device.type == "cpu":
        return philox4x32_reference(counter, key)
    _require_cuda(counter)
    with torch.cuda.device(counter.device):
        c32 = (counter & _MASK32).to(torch.int32).contiguous()
        k32 = (key & _MASK32).to(torch.int32).contiguous()
        out = torch.empty((n, 4), dtype=torch.int32, device=counter.device)
        _launch("philox4x32", _ptr(c32), _ptr(k32), _ptr(out), n)
    return out.to(torch.int64) & _MASK32
