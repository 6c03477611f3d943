"""The small 17 x 4-cell n-tuple network, and what the big networks share
with it.

Counterpart of ``gym2048_tpu/models/ntuple.py``. The value of a board is
the mean over its 8 symmetries of the sum of one table entry per tuple: the
17 four-cell tuples (4 rows, 4 columns, 9 2x2 squares) over 17 exponent
values give 17 x 17**4 = 1,419,857 f32 entries (5.7 MB) a stage, 136
lookups a board.

The small net's flat indices are exactly those of
``ntuple_big.NTupleNetwork(TUPLES, n_vals=17)`` (the same cells, powers of
17, sub-tables 83,521 apart, a stage stride of :data:`STAGE_STRIDE`), so
its lookups and TD updates run through one such instance
(:func:`network`): on the card every lookup is the table gather kernel
(:func:`gym2048_tpu_torch.models.table_gather.gather_values`).

The JAX module's ``"mxu"`` modes are matmul forms for the TPU. Their
numbers are ported, not their form: :func:`split_table` and
:func:`value_batch_mxu` are two lookups (or one) into the split halves.
``td_update_mxu`` and ``td_update_tc_mxu`` work around XLA:TPU's serial
scatter and give the scatter's sums; they are not ported, and the trainer's
``update_impl="mxu"`` runs :func:`td_update` / :func:`td_update_tc`.

Shared with the big networks: the 8 board symmetries (``SYMS``), the stage
of a board in a staged table (:func:`stage_of_batch`), weight promotion
(:func:`promote_table`) and the temporal-coherence combine
(:func:`_tc_combine`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gym2048_tpu_torch.models.table_gather import gather_values

N_VALS = 17  # the small net's exponent domain, 0..16
TUPLE_LEN = 4
TABLE_SIZE = N_VALS ** TUPLE_LEN  # 83521
N_TUPLES = 17  # 4 rows, 4 columns, 9 2x2 squares
STAGE_STRIDE = N_TUPLES * TABLE_SIZE  # one stage of the small net's table
N_FEATURES = 8 * N_TUPLES  # lookups per board


def _build_tuples() -> np.ndarray:
    """The 17 four-cell tuples: 4 rows, 4 columns, 9 2x2 squares."""
    tuples = [[4 * i + j for j in range(4)] for i in range(4)]
    tuples += [[4 * i + j for i in range(4)] for j in range(4)]
    tuples += [[4 * i + j, 4 * i + j + 1, 4 * (i + 1) + j, 4 * (i + 1) + j + 1]
               for i in range(3) for j in range(3)]
    return np.asarray(tuples, np.int32)  # (17, 4)


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


TUPLES = _build_tuples()
SYMS = _build_symmetries()
# CELLS[s, m, k]: the board cell feeding slot k of tuple m under symmetry s
CELLS = SYMS[:, TUPLES]  # (8, 17, 4)
_POW = np.asarray(N_VALS ** np.arange(TUPLE_LEN), np.int32)  # (4,)
_OFFSET = np.asarray((np.arange(N_TUPLES) * TABLE_SIZE)[None, :], np.int32)  # (1, 17)
VALUE_IMPLS = ("gather", "mxu", "mxu_bf16")


@functools.cache
def network(thresholds: tuple[int, ...] = ()):
    """The small net as an ``ntuple_big.NTupleNetwork(TUPLES, 17,
    thresholds)``, whose flat indices are the small net's. Built at its
    first use (``ntuple_big`` imports this module) and kept."""
    from gym2048_tpu_torch.models.ntuple_big import NTupleNetwork

    return NTupleNetwork(TUPLES, N_VALS, tuple(int(t) for t in thresholds))


def init_table(value: float = 0.0, n_stages: int = 1,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Flat ``(n_stages * 17 * 83521,)`` f32 table, every entry ``value``."""
    return torch.full((n_stages * STAGE_STRIDE,), value, dtype=torch.float32, device=device)


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


def local_indices_batch(boards: torch.Tensor) -> torch.Tensor:
    """Per-tuple local indices ``(B, 8, 17)`` int32 in ``[0, 83521)`` of
    ``(B, 4, 4)`` exponent boards (exponents clip to 16): plain integer
    arithmetic, where the JAX module uses an exact f32 selection matmul."""
    offsets = torch.as_tensor(_OFFSET, device=boards.device)
    return network().indices_batch(boards).reshape(boards.shape[0], 8, N_TUPLES) - offsets


def local_indices(board: torch.Tensor) -> torch.Tensor:
    """Per-tuple local indices ``(8, 17)`` of one ``(4, 4)`` board (row s =
    symmetry, column m = tuple)."""
    return local_indices_batch(board[None])[0]


def feature_indices(board: torch.Tensor) -> torch.Tensor:
    """Flat table indices ``(136,)`` of one ``(4, 4)`` board."""
    return network().indices_batch(board[None])[0]


def value_batch(table: torch.Tensor, boards: torch.Tensor,
                thresholds: tuple[int, ...] = ()) -> torch.Tensor:
    """Values ``(B,)`` of ``(B, 4, 4)`` boards: one lookup of ``136 B``
    entries (of each board's stage table with ``thresholds``), the sum of
    each board's 136 over 8."""
    return network(tuple(thresholds)).value_batch(table, boards)


def value(table: torch.Tensor, board: torch.Tensor,
          thresholds: tuple[int, ...] = ()) -> torch.Tensor:
    """Value of one ``(4, 4)`` board, a 0-d tensor."""
    return value_batch(table, board[None], thresholds)[0]


def split_table(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a flat f32 table into ``(hi, lo)``, two flat f32 tables in the
    table's own layout (not the JAX module's padded ``(17, S * 653, 128)``
    matmul layout): ``hi`` is each entry rounded to bf16 (to nearest,
    ties to even: ``reduce_precision(t, 8, 7)``), ``lo`` the rest rounded
    to bf16, ``bf16(t - hi)``, as the TPU computes it; ``hi + lo`` is the
    entry to ~2**-16 relative. On the CPU the JAX module keeps ``lo`` in
    f32 (its ``_mxu_dtype``), which is the rest exactly."""
    n_stages_of(table)
    hi = table.to(torch.bfloat16).to(torch.float32)
    lo = (table - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def value_batch_mxu(t_hi: torch.Tensor, t_lo: torch.Tensor | None, boards: torch.Tensor,
                    chunk: int = 4096, thresholds: tuple[int, ...] = ()) -> torch.Tensor:
    """:func:`value_batch` over the halves of :func:`split_table`: each
    entry is ``hi + lo`` (the exact split lookup, ``value_impl="mxu"``), or
    ``hi`` alone when ``t_lo`` is None (the bf16 lookup, ``"mxu_bf16"``).
    One index computation and one lookup kernel launch per half. Pass the
    ``thresholds`` a staged table was trained with. ``chunk`` (the JAX
    module's scan chunk) has no meaning here."""
    thresholds = tuple(thresholds)
    if n_stages_of(t_hi) != len(thresholds) + 1:
        raise ValueError(f"table has {n_stages_of(t_hi)} stages but "
                         f"thresholds={thresholds!r}")
    idx = network(thresholds).indices_batch(boards).reshape(-1)
    v = gather_values(t_hi, idx)
    if t_lo is not None:
        v = v + gather_values(t_lo, idx)
    return v.reshape(-1, N_FEATURES).sum(-1) / 8.0


def td_update(table: torch.Tensor, boards: torch.Tensor, deltas: torch.Tensor, alpha,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Count-normalised TD update of the stage-0 entries of ``boards``'
    features: each touched entry moves by the mean of the ``alpha * delta
    * 8 / 136`` occurrences that hit it, so one board's value moves by
    exactly ``alpha * delta``; boards with ``valid`` False contribute
    nothing. Returns a new table."""
    return network().td_update(table, boards, deltas, alpha, valid)


def td_update_tc(table: torch.Tensor, tc_e: torch.Tensor, tc_a: torch.Tensor,
                 boards: torch.Tensor, deltas: torch.Tensor, alpha,
                 valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Temporal-coherence TD update (Beal & Smith 1999): entry rates
    ``|tc_e| / tc_a`` over the signed and absolute masses of the updates
    that hit it, ``alpha`` the meta-rate. Returns new ``(table, tc_e,
    tc_a)``."""
    return network().td_update_tc(table, tc_e, tc_a, boards, deltas, alpha, valid)


class SmallNet:
    """The small net evaluated by one of the JAX package's value modes,
    with the interface of the big networks that the agents and the trainer
    take: :meth:`params` turns a table into what :meth:`value_batch` reads
    (the table for ``"gather"``, its split halves for ``"mxu"`` and
    ``"mxu_bf16"``), once per table, and :meth:`make_value_fn` binds it. ``"auto"``
    is ``"gather"``, the exact lookup, as JAX's is off the TPU."""

    def __init__(self, value_impl: str = "gather", thresholds: tuple[int, ...] = ()):
        value_impl = "gather" if value_impl == "auto" else value_impl
        if value_impl not in VALUE_IMPLS:
            raise ValueError(f"the small net's value_impl is auto or one of "
                             f"{VALUE_IMPLS}, got {value_impl!r}")
        self.value_impl = value_impl
        self.thresholds = tuple(int(t) for t in thresholds)

    def params(self, table: torch.Tensor):
        if self.value_impl == "gather":
            return table
        hi, lo = split_table(table)
        return hi, (lo if self.value_impl == "mxu" else None)

    def value_batch(self, params, boards: torch.Tensor) -> torch.Tensor:
        if self.value_impl == "gather":
            return value_batch(params, boards, self.thresholds)
        return value_batch_mxu(params[0], params[1], boards, thresholds=self.thresholds)

    def make_value_fn(self, table: torch.Tensor):
        """Bind ``table`` (split here, once, in the ``"mxu"`` modes) into a
        ``(N, 4, 4) -> (N,)`` value function."""
        params = self.params(table)
        return lambda boards: self.value_batch(params, boards)


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
