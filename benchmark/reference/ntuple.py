"""The n-tuple value network, written plainly for the check.

A board's value is the mean over the 8 symmetries of the square of the
sum, over the tuples, of one table entry each: the entry that the tuple's
cells (exponents clipped to ``n_vals - 1``) address in the tuple's
sub-table of ``n_vals ** len(tuple)`` entries, the first cell the least
significant digit. With stage ``thresholds`` the table holds one copy of
every sub-table per stage, and a board reads the copy of the number of
thresholds its highest exponent has reached (arXiv:1604.05085).

The features of a board are ordered symmetry-major: symmetry s, then tuple
m. Symmetry s maps board position p to ``SYMS[s][p]``: the four rotations
of the board, each followed by its mirror image.

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch


def symmetries() -> list[list[int]]:
    """The 8 symmetries as flat-position maps: position p of the turned
    board reads position ``SYMS[s][p]`` of the board."""
    grid = [[4 * r + c for c in range(4)] for r in range(4)]
    out = []
    for _ in range(4):
        out.append([p for row in grid for p in row])
        out.append([p for row in grid for p in reversed(row)])
        grid = [[grid[r][3 - c] for r in range(4)] for c in range(4)]  # a quarter turn
    return out


class Network:
    """The value network of a configuration's ``tuples``, ``n_vals`` and
    ``thresholds``, on ``device``."""

    def __init__(self, tuples, n_vals: int, thresholds, device):
        self.tuples = [list(t) for t in tuples]
        self.n_vals = n_vals
        self.thresholds = list(thresholds)
        sizes = [n_vals ** len(t) for t in self.tuples]
        self.stage_size = sum(sizes)
        self.size = self.stage_size * (len(self.thresholds) + 1)
        self.n_features = 8 * len(self.tuples)
        cells, digits, offsets = [], [], []
        start = 0
        for t, size in zip(self.tuples, sizes):
            offsets.append(start)
            start += size
        syms = symmetries()
        width = max(len(t) for t in self.tuples)
        for s in syms:
            for t in self.tuples:
                cells.append([s[c] for c in t] + [0] * (width - len(t)))
                digits.append([n_vals ** k for k in range(len(t))] + [0] * (width - len(t)))
        self.cells = torch.tensor(cells, device=device)  # (8T, width)
        self.digits = torch.tensor(digits, device=device)
        self.offsets = torch.tensor(offsets * 8, device=device)  # (8T,)

    def stage(self, boards: torch.Tensor) -> torch.Tensor:
        top = boards.reshape(-1, 16).amax(-1).to(torch.int64)
        s = torch.zeros_like(top)
        for t in self.thresholds:
            s += (top >= t).to(torch.int64)
        return s

    def indices(self, boards: torch.Tensor) -> torch.Tensor:
        """Table indices ``(N, 8T)`` int64 of ``(N, 4, 4)`` boards."""
        flat = boards.reshape(-1, 16).to(torch.int64).clamp(0, self.n_vals - 1)
        vals = flat[:, self.cells]  # (N, 8T, width)
        idx = (vals * self.digits).sum(-1) + self.offsets
        return idx + (self.stage(boards) * self.stage_size)[:, None]

    def values(self, table: torch.Tensor, boards: torch.Tensor) -> torch.Tensor:
        """Values ``(N,)`` in the table's dtype."""
        return table[self.indices(boards)].sum(-1) / 8.0
