"""What the big n-tuple network, its trainer and the agents need from the
small one.

Counterpart of ``gym2048_tpu/models/ntuple.py``: the 8 board symmetries
(``SYMS``), the stage of a board in a staged table (``stage_of_batch``),
weight promotion (``promote_table``) and the temporal-coherence combine
(``_tc_combine``). The small 17 x 4-cell network itself (its lookups and TD
updates) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

N_VALS = 17  # the small net's exponent domain, 0..16
TUPLE_LEN = 4
TABLE_SIZE = N_VALS ** TUPLE_LEN  # 83521
N_TUPLES = 17  # 4 rows, 4 columns, 9 2x2 squares
STAGE_STRIDE = N_TUPLES * TABLE_SIZE  # one stage of the small net's table


def _build_symmetries() -> np.ndarray:
    """The 8 symmetries of the 4x4 board as flat-position permutations:
    ``SYMS[s, p]`` is the source position that lands at ``p`` under
    symmetry ``s`` (``ntuple._build_symmetries``)."""
    m = np.arange(16).reshape(4, 4)
    syms = []
    for _ in range(4):
        syms.append(m.reshape(-1))
        syms.append(np.fliplr(m).reshape(-1))
        m = np.rot90(m)
    return np.asarray(syms, np.int32)  # (8, 16)


SYMS = _build_symmetries()


def n_stages_of(table: torch.Tensor) -> int:
    """Number of stages a flat small-net table holds."""
    n, rem = divmod(table.shape[-1] if table.dim() else table.numel(), STAGE_STRIDE)
    if rem or n < 1:
        raise ValueError(f"not a stage-multiple table: {tuple(table.shape)}")
    return n


def promote_table(table: torch.Tensor, n_stages: int) -> torch.Tensor:
    """Seed every stage of a fresh ``n_stages``-stage table with a trained
    single-stage table (weight promotion, arXiv:1604.05085)."""
    if n_stages_of(table) != 1:
        raise ValueError("promote from a single-stage table")
    return table.repeat(n_stages)


def stage_of_batch(boards: torch.Tensor, thresholds: tuple[int, ...]) -> torch.Tensor:
    """Stage ``(B,)`` int32 of each ``(B, 4, 4)`` board: how many of the
    max-tile-exponent ``thresholds`` its highest tile has reached (0 for
    no thresholds). The raw maximum is used, not the clipped one of the
    feature indices."""
    m = boards.reshape(boards.shape[0], 16).amax(-1).to(torch.int32)
    s = torch.zeros_like(m)
    for t in thresholds:
        s = s + (m >= t).to(torch.int32)
    return s


def _tc_combine(table, tc_e, tc_a, sums, absums, cnts, alpha):
    """Temporal-coherence update of flat f32 arrays (``ntuple._tc_combine``):
    add the signed and absolute TD-error masses ``sums`` / ``absums`` into
    ``tc_e`` / ``tc_a``, derive each entry's coherence rate ``|E| / A``
    (1.0 for an entry never touched), and move ``table`` by ``alpha`` x rate
    x the count-normalised mean update. Returns new ``(table, tc_e, tc_a)``;
    the inputs are not modified.

    The operations and their order are the JAX module's,
    ``table + alpha * rate * d``, each rounded as the expression reads (as
    JAX runs it op by op; compiled, XLA's CPU backend fuses the last
    multiply-add into one rounding). The in-place steps below only reuse
    temporaries. At the flagship width each array is 805 MB.
    """
    d = sums / cnts.clamp(min=1.0)
    e2 = tc_e + sums
    a2 = tc_a + absums
    rate = e2.abs().div_(a2.clamp(min=1e-30))
    rate.masked_fill_(~(a2 > 0.0), 1.0)  # where(a2 > 0, rate, 1), NaN included
    step = rate.mul_(alpha).mul_(d)  # (alpha * rate) * d
    return table + step, e2, a2
