"""Large n-tuple value networks over device-resident tables.

Counterpart of ``gym2048_tpu/models/ntuple_big.py``: the named tuple
layouts (``LAYOUTS``), :class:`NTupleNetwork` and :func:`make_network`.
All of the JAX class is ported: the geometry,
:meth:`NTupleNetwork.indices_batch`, :meth:`~NTupleNetwork.init_table`,
:meth:`~NTupleNetwork.value_batch`, :meth:`~NTupleNetwork.make_value_fn`
and the TD updates (:meth:`~NTupleNetwork.td_update`,
:meth:`~NTupleNetwork.td_update_tc`, :meth:`~NTupleNetwork.tc_accumulate`).

A board's value is the mean over the 8 symmetries of the sum of one table
entry per tuple. The flat table holds one sub-table of ``n_vals ** len(t)``
entries per tuple, and with ``thresholds`` one full copy per stage
(arXiv:1604.05085). The flagship layout, ``4x6`` with ``n_vals=16`` and
thresholds (12, 13), has 3 x 67,108,864 = 201,326,592 f32 entries (805 MB).

Feature indices are plain integer arithmetic; the JAX module builds them
with an f32 one-hot matmul that is exact below 2**24, so both give the same
indices. The lookup is :func:`gym2048_tpu_torch.models.table_gather.gather_values`,
the CUDA kernel on the card.

A TD update is a count-normalised scatter: each touched entry moves by the
MEAN of the per-occurrence updates that hit it (a plain scatter-add of the
updates diverges; ``docs/PERF.md``, "Stability note"). The scatters are
``index_add_``, as the JAX module leaves them to XLA's scatter. On CUDA its
float atomics add duplicates in no fixed order, so the bits of a sum can
differ from run to run unless ``torch.use_deterministic_algorithms(True)``
is set, which gives ``index_add_`` a deterministic path.
"""

from __future__ import annotations

import numpy as np
import torch

from gym2048_tpu_torch.models.ntuple import SYMS, _tc_combine, stage_of_batch
from gym2048_tpu_torch.models.table_gather import gather_values

_LANES = 128  # the JAX module's "rows" modes need a table of whole 128-lane rows

# flat row-major cell indices on the 4x4 board (ntuple_big.LAYOUTS)
LAYOUTS: dict[str, tuple[tuple[int, ...], ...]] = {
    "4x6": (
        (0, 1, 2, 3, 4, 5),
        (4, 5, 6, 7, 8, 9),
        (0, 1, 2, 4, 5, 6),
        (4, 5, 6, 8, 9, 10),
    ),
    "5x6": (
        (0, 1, 2, 3, 4, 5),
        (4, 5, 6, 7, 8, 9),
        (8, 9, 10, 11, 12, 13),
        (0, 1, 2, 4, 5, 6),
        (4, 5, 6, 8, 9, 10),
    ),
    "4x6_4x4": (
        (0, 1, 2, 3, 4, 5),
        (4, 5, 6, 7, 8, 9),
        (0, 1, 2, 4, 5, 6),
        (4, 5, 6, 8, 9, 10),
        (0, 1, 2, 3),
        (0, 4, 8, 12),
        (0, 1, 4, 5),
        (5, 6, 9, 10),
    ),
}


class NTupleNetwork:
    """An n-tuple value network over a flat f32 table.

    ``tuples`` are cell-index tuples (lengths may differ); ``n_vals`` is the
    exponent domain per cell (exponents clip to ``n_vals - 1``);
    ``thresholds`` are the max-tile-exponent stage boundaries. ``value_impl``
    and ``update_impl`` are accepted for the JAX signature: their "rows"
    modes are 128-lane forms for the TPU that give the same numbers as
    "gather" and "scatter" there, and here every mode is the one lookup
    kernel and the one scatter. As in JAX, a table whose size is not a
    multiple of 128 records "gather" and "scatter".
    """

    def __init__(self, tuples, n_vals: int = 16, thresholds: tuple[int, ...] = (),
                 value_impl: str = "gather", update_impl: str = "scatter"):
        tuples = tuple(tuple(int(c) for c in t) for t in tuples)
        if not tuples or not all(0 <= c < 16 for t in tuples for c in t):
            raise ValueError(f"tuples must hold cells 0..15, got {tuples}")
        if value_impl not in ("gather", "rows"):
            raise ValueError(f"unknown value_impl {value_impl!r}")
        if update_impl not in ("scatter", "rows"):
            raise ValueError(f"unknown update_impl {update_impl!r}")
        self.tuples = tuples
        self.n_vals = int(n_vals)
        self.thresholds = tuple(int(t) for t in thresholds)
        self.n_tuples = len(tuples)
        self.n_features = 8 * self.n_tuples  # lookups per board
        self.max_len = max(len(t) for t in tuples)
        if self.n_vals ** self.max_len > 2 ** 24:  # the JAX module's limit
            raise ValueError("index domain exceeds 2**24; reduce n_vals or "
                             "tuple length")
        sizes = [self.n_vals ** len(t) for t in tuples]
        self.sub_sizes = np.asarray(sizes, np.int64)
        self.stage_stride = int(sum(sizes))
        self.n_stages = len(self.thresholds) + 1
        self.table_size = self.stage_stride * self.n_stages
        if self.table_size >= 2 ** 31:
            raise ValueError("table too large for int32 indices")
        if self.table_size % _LANES:
            value_impl, update_impl = "gather", "scatter"
        self.value_impl = value_impl
        self.update_impl = update_impl
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

        # every tuple padded to max_len with (cell 0, positional base 0): a
        # padded slot adds value * 0
        cells = np.zeros((self.n_tuples, self.max_len), np.int64)
        pows = np.zeros((self.n_tuples, self.max_len), np.int32)
        for m, t in enumerate(tuples):
            cells[m, :len(t)] = t
            pows[m, :len(t)] = self.n_vals ** np.arange(len(t))
        # _cells[s, m, k]: the board cell feeding slot k of tuple m under
        # symmetry s
        self._cells = torch.from_numpy(SYMS[:, cells].reshape(-1).astype(np.int64))
        self._pows = torch.from_numpy(pows)  # (T, L)
        self._offsets = torch.from_numpy(offsets)  # (T,)
        self._consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def _on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The index constants on ``device``, copied there once."""
        if device not in self._consts:
            self._consts[device] = tuple(t.to(device) for t in
                                         (self._cells, self._pows, self._offsets))
        return self._consts[device]

    def indices_batch(self, boards: torch.Tensor) -> torch.Tensor:
        """Flat table indices ``(B, 8 * T)`` int32 for ``(B, 4, 4)`` boards,
        stage offset included when the network is staged."""
        n = boards.shape[0]
        cells, pows, offsets = self._on(boards.device)
        flat = boards.reshape(n, 16).to(torch.int32).clamp(0, self.n_vals - 1)
        vals = flat.index_select(1, cells).reshape(n, 8, self.n_tuples, self.max_len)
        idx = (vals * pows).sum(-1, dtype=torch.int32) + offsets  # (B, 8, T)
        if self.thresholds:
            st = stage_of_batch(boards, self.thresholds)
            idx = idx + (st * self.stage_stride)[:, None, None]
        return idx.reshape(n, self.n_features)

    def init_table(self, init_value: float = 0.0,
                   device: str | torch.device = "cuda") -> torch.Tensor:
        """Flat ``(table_size,)`` f32 table; ``init_value`` is the initial
        value of a board whose features are all distinct (spread over the
        ``n_tuples`` summands)."""
        return torch.full((self.table_size,), init_value / self.n_tuples,
                          dtype=torch.float32, device=device)

    def value_batch(self, table: torch.Tensor, boards: torch.Tensor) -> torch.Tensor:
        """Values ``(B,)`` of ``(B, 4, 4)`` boards: one lookup of ``B * 8T``
        entries, then the mean over the 8 symmetries of the tuple sums."""
        idx = self.indices_batch(boards)
        vals = gather_values(table, idx.reshape(-1)).reshape(idx.shape)
        return vals.sum(-1) / 8.0

    def make_value_fn(self, table: torch.Tensor):
        """Bind ``table`` into a ``(N, 4, 4) -> (N,)`` value function."""
        return lambda boards: self.value_batch(table, boards)

    def td_update(self, table: torch.Tensor, boards: torch.Tensor,
                  deltas: torch.Tensor, alpha, valid: torch.Tensor | None = None
                  ) -> torch.Tensor:
        """Count-normalised TD update: each entry touched by the ``(B, 4, 4)``
        ``boards`` receives the mean of the ``alpha * deltas`` occurrences
        that hit it, so a single board's value moves by exactly ``alpha *
        delta`` even where its symmetries collide on an entry. Boards with
        ``valid`` False contribute nothing. The table is written IN PLACE
        (``add_``, one rounding as ``+``), so that a CUDA graph that reads
        it keeps reading the learner's table, and returned."""
        sums, cnts = self._scatter2(boards, (alpha * 8.0 / self.n_features) * deltas,
                                    valid, table.numel())
        return table.add_(sums / cnts.clamp(min=1.0))

    def td_update_tc(self, table: torch.Tensor, tc_e: torch.Tensor,
                     tc_a: torch.Tensor, boards: torch.Tensor, deltas: torch.Tensor,
                     alpha, valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Temporal-coherence TD update (Beal & Smith 1999): each entry's rate
        is ``|sum of its updates| / sum of their magnitudes``, kept in
        ``tc_e`` / ``tc_a``. Three scatters on one index vector, then
        :func:`~gym2048_tpu_torch.models.ntuple._tc_combine`, which writes
        the table IN PLACE (as :meth:`td_update`). Returns ``(table, tc_e,
        tc_a)``, the accumulators new."""
        w0 = (8.0 / self.n_features) * deltas
        sums, absums, cnts = self._scatter3(boards, w0, valid, table.numel())
        return _tc_combine(table, tc_e, tc_a, sums, absums, cnts, alpha)

    def tc_accumulate(self, pending: tuple, boards: torch.Tensor, deltas: torch.Tensor,
                      valid: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Add one step's TC statistics into the table-sized ``pending``
        ``(sums, absums, counts)`` buffers without touching the table: the
        accumulation half of delayed TC learning (arXiv:1604.05085), whose
        combine runs every k steps. The buffers are updated IN PLACE (the
        JAX module's functional update would copy them every step) and
        returned. Combining the accumulated buffers with ``_tc_combine`` is
        one TC update of the concatenated steps.

        ``pending`` may hold a fourth element, the window's index record
        ``(rows, step)``: a ``(k, B * 8T)`` int32 buffer and a ``(1,)``
        int64 step counter on the device. The step's flat occurrence
        indices, those the sums were scattered at (a masked occurrence at
        0), are then written into row ``step % k`` of ``rows``, which
        ``ntuple.tc_combine_at`` reads, with no host scalar (a CUDA graph
        holds the write)."""
        w0 = (8.0 / self.n_features) * deltas
        idx, w, keep = self._flat_updates(boards, w0, valid)
        if len(pending) == 4:
            rows, step = pending[3]
            rows.index_copy_(0, step % rows.shape[0], idx.view(1, -1))
        payloads = (w, w.abs(), torch.ones_like(w))
        if keep is not None:
            payloads = tuple(torch.where(keep, p, 0.0) for p in payloads)
        return tuple(acc.index_add_(0, idx, p) for acc, p in zip(pending, payloads))

    def _flat_updates(self, boards, w_board, valid):
        """Flat indices ``(B * 8T,)``, per-occurrence weights, and the
        ``valid`` mask broadcast to occurrences (``None`` without a mask).
        A masked occurrence gets index 0 and, in :meth:`_scatter_add`, zero
        in every channel, its count included: entry 0 only ever receives
        exact zeros, and the count-normalised mean is unaffected."""
        n = boards.shape[0]
        idx = self.indices_batch(boards).reshape(-1)
        w = w_board[:, None].expand(n, self.n_features).reshape(-1)
        keep = None
        if valid is not None:
            keep = valid[:, None].expand(n, self.n_features).reshape(-1)
            idx = torch.where(keep, idx, 0)
        return idx, w, keep

    def _scatter2(self, boards, w_board, valid, size=None):
        idx, w, keep = self._flat_updates(boards, w_board, valid)
        return self._scatter_add(idx, (w, torch.ones_like(w)), keep, size)

    def _scatter3(self, boards, w_board, valid, size=None):
        idx, w, keep = self._flat_updates(boards, w_board, valid)
        return self._scatter_add(idx, (w, w.abs(), torch.ones_like(w)), keep, size)

    def _scatter_add(self, idx, payloads, keep=None, size=None):
        """Scatter-add each scalar channel of ``payloads`` at the shared flat
        ``idx`` into a zero array of ``size`` entries (the table's; more
        where a small-net table holds stages that the update does not
        touch): one ``index_add_`` per channel, as the JAX module's
        "scatter" mode has one scatter per channel. Its "rows" mode
        (one-hot 128-lane rows, for the TPU) gives the same sums and takes
        this path too."""
        if keep is not None:
            payloads = tuple(torch.where(keep, p, 0.0) for p in payloads)
        size = self.table_size if size is None else size
        return tuple(torch.zeros(size, dtype=torch.float32, device=idx.device)
                     .index_add_(0, idx, p) for p in payloads)


def make_network(arch: str, n_vals: int = 16, thresholds: tuple[int, ...] = (),
                 value_impl: str = "gather", update_impl: str = "scatter"
                 ) -> NTupleNetwork:
    """Build a named layout (see :data:`LAYOUTS`)."""
    if arch not in LAYOUTS:
        raise ValueError(f"unknown n-tuple layout {arch!r}; choose from "
                         f"{sorted(LAYOUTS)}")
    return NTupleNetwork(LAYOUTS[arch], n_vals, thresholds, value_impl=value_impl,
                         update_impl=update_impl)
