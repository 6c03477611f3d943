"""The step CUDA kernels' own code, compiled for the host with g++.

``gym2048_tpu_torch/csrc/fused_step.cu`` keeps its device code (everything
inside its anonymous namespace) free of CUDA-only constructs but a few
qualifiers, builtins and ``__umulhi``. Defined away in a small header, the
same source compiles as plain C++: here each kernel is called once per
board from a loop (one block of one thread each) and its outputs are held
bit for bit against the port's plain versions (``core/fused_step.py``),
which the other tests hold against the JAX package. This checks the
kernels' logic on the CPU, not what ``nvcc`` makes of it; chip_smoke.py
holds the built kernels against the same plain versions on the card.
``fused_move`` is checked over every line of exponents 0-17 in a row and
in a column, in all four directions; ``fused_step_uniform`` on the board
families of chip_smoke.py at four win exponents; ``fused_rollout`` (its
Philox stream included) on random boards, on the families at four win
exponents and from empty boards long enough for resets.
"""

import itertools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gym2048_tpu_torch.core import fused_step as fs

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repository's GPU check, importable without a GPU)

SOURCE = ROOT / "gym2048_tpu_torch/csrc/fused_step.cu"

STUB = """
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <algorithm>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct Index { unsigned x; };
static Index blockIdx, blockDim{1}, threadIdx{0};
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
using std::min;
using std::max;
"""

# kernel [move|step|rollout] n max_tile_exp seed steps
#   < boards (int32 16*n) [actions (int32 n) | u (f32 8*n)]
HARNESS = """
int main(int argc, char** argv) {
  const char kind = argv[1][0];
  const long long n = atoll(argv[2]);
  const int max_tile_exp = atoi(argv[3]);
  const uint32_t seed = static_cast<uint32_t>(strtoul(argv[4], nullptr, 10));
  const int steps = atoi(argv[5]);
  std::vector<int> board(16 * n), out(16 * n), action(n), a(n), b(n);
  std::vector<float> u(8 * n), score(n), total(n);
  fread(board.data(), 4, 16 * n, stdin);
  if (kind == 'm') fread(action.data(), 4, n, stdin);
  if (kind == 's') fread(u.data(), 4, 8 * n, stdin);
  for (long long i = 0; i < n; ++i) {
    blockIdx.x = static_cast<unsigned>(i);
    if (kind == 'm')
      fused_move_kernel(board.data(), action.data(), out.data(), a.data(), b.data(), n);
    else if (kind == 's')
      fused_step_uniform_kernel(board.data(), u.data(), out.data(), score.data(),
                                a.data(), b.data(), n, max_tile_exp);
    else
      fused_rollout_kernel(board.data(), seed, steps, max_tile_exp, out.data(),
                           score.data(), a.data(), total.data(), n);
  }
  fwrite(out.data(), 4, 16 * n, stdout);
  if (kind != 'm') fwrite(score.data(), 4, n, stdout);
  fwrite(a.data(), 4, n, stdout);
  fwrite(kind == 'r' ? static_cast<const void*>(total.data()) : b.data(), 4, n, stdout);
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    text = SOURCE.read_text()
    start, end = text.index("namespace {\n"), text.index("}  // namespace\n")
    cpp = tmp_path_factory.mktemp("fused_step_host") / "harness.cpp"
    cpp.write_text(STUB + text[start:end] + "}  // namespace\n" + HARNESS)
    exe = cpp.with_suffix("")
    subprocess.run(["g++", "-std=c++17", "-O2", "-o", str(exe), str(cpp)],
                   check=True, capture_output=True, text=True)
    return exe


def run(exe, kernel: str, cm: torch.Tensor, extra: np.ndarray, max_tile_exp: int = 0,
        seed: int = 0, steps: int = 0):
    n = cm.shape[1]
    done = subprocess.run([str(exe), kernel, str(n), str(max_tile_exp), str(seed), str(steps)],
                          input=cm.numpy().astype(np.int32).tobytes() + extra.tobytes(),
                          capture_output=True, check=True).stdout
    out = np.frombuffer(done, np.int32)
    board, rest = out[:16 * n].reshape(16, n), out[16 * n:]
    if kernel == "move":
        return board, rest[:n], rest[n:]
    if kernel == "rollout":  # board, score, episodes, total
        return board, rest[:n].view(np.float32), rest[n:2 * n], rest[2 * n:].view(np.float32)
    return board, rest[:n].view(np.float32), rest[n:2 * n], rest[2 * n:]


def line_boards() -> np.ndarray:
    """Every line of exponents 0-17 (18^4) in row 0 and, again, in column 0
    of an empty board."""
    lines = np.array(list(itertools.product(range(18), repeat=4)), np.int32)
    boards = np.zeros((2, lines.shape[0], 4, 4), np.int32)
    boards[0, :, 0, :] = lines
    boards[1, :, :, 0] = lines
    return boards.reshape(-1, 4, 4)


@pytest.mark.parametrize("action", [0, 1, 2, 3])
def test_fused_move_kernel_exhaustive_over_lines(harness, action):
    cm = fs.to_cell_major(torch.as_tensor(line_boards()))
    act = np.full(cm.shape[1], action, np.int32)
    got = run(harness, "move", cm, act)
    want = fs.fused_move_reference(cm, torch.as_tensor(act))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_fused_move_kernel_on_board_families(harness):
    boards, _ = chip_smoke.adversarial_boards(np.random.default_rng(11), 16384)
    cm = fs.to_cell_major(torch.as_tensor(boards.astype(np.int32)))
    act = np.random.default_rng(12).integers(0, 4, cm.shape[1]).astype(np.int32)
    got = run(harness, "move", cm, act)
    want = fs.fused_move_reference(cm, torch.as_tensor(act))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("max_tile_exp", [0, 2, 11, 17])
def test_fused_step_uniform_kernel_on_board_families(harness, max_tile_exp):
    boards, _ = chip_smoke.adversarial_boards(np.random.default_rng(max_tile_exp), 16384)
    cm = fs.to_cell_major(torch.as_tensor(boards.astype(np.int32)))
    u = np.random.default_rng(50 + max_tile_exp).random((8, cm.shape[1]), dtype=np.float32)
    got = run(harness, "step", cm, u, max_tile_exp)
    want = fs.fused_step_uniform_reference(cm, torch.as_tensor(u), max_tile_exp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    finished = got[2] == 1
    assert finished.any() and not finished.all()


def rollout_matches_plain(exe, cm: torch.Tensor, seed: int, steps: int, max_tile_exp: int = 0):
    """The rollout kernel's four outputs, each equal bit for bit to the plain
    version's; returns the episodes."""
    got = run(exe, "rollout", cm, np.zeros(0, np.int32), max_tile_exp, seed, steps)
    want = fs.fused_rollout_reference(cm, seed, steps, max_tile_exp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    return got[2]


def test_fused_rollout_kernel_on_random_boards(harness):
    boards = chip_smoke.random_boards(np.random.default_rng(21), 4096, 6, 0.6)
    cm = fs.to_cell_major(torch.as_tensor(boards.astype(np.int32)))
    rollout_matches_plain(harness, cm, 5, 64)


@pytest.mark.parametrize("max_tile_exp", [0, 2, 11, 17])
def test_fused_rollout_kernel_on_board_families(harness, max_tile_exp):
    boards, _ = chip_smoke.adversarial_boards(np.random.default_rng(30 + max_tile_exp), 16384)
    cm = fs.to_cell_major(torch.as_tensor(boards.astype(np.int32)))
    episodes = rollout_matches_plain(harness, cm, 1000 + max_tile_exp, 32, max_tile_exp)
    # boards finished, and not all equally often (at max_tile_exp 2 every
    # board reaches a 2 within 32 steps, some of them more than once)
    assert episodes.max() > 0 and episodes.min() < episodes.max()


def test_fused_rollout_kernel_with_resets(harness):
    """From empty boards past the length of a random game, so that most
    boards reset at least once, with the seed's high bit set."""
    cm = torch.zeros((16, 2048), dtype=torch.int32)
    episodes = rollout_matches_plain(harness, cm, 0x9E3779B9, 300)
    assert (episodes > 0).mean() > 0.9
