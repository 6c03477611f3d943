"""Host-side reference RNG streams for bit-exact batched replay (counterpart
of ``gym2048_tpu/env/parity.py``, without gymnasium).

The reference spawns tiles by consuming gymnasium's seeded NumPy PCG64
generator — one ``np_random.random()`` for the 2-vs-4 draw, then one
``np_random.shuffle`` of the 16-position list, placing the tile at the
first *empty* position in shuffled order (game2048_env.py:166-176;
``reset`` does this twice, game2048_env.py:102-111). Parity mode splits the
work: this module replays the exact host RNG stream into ``(value exponent,
shuffle rank)`` arrays, and ``rules.spawn_ranked`` applies them on the
device (``batched.reset_parity`` / ``batched.step_parity``), which then
reproduce reference trajectories bit for bit.

:func:`np_random` is gymnasium's ``seeding.np_random`` in numpy alone:
``Generator(PCG64(SeedSequence(seed)))``, so the streams are gymnasium's
without importing it.

Key property preserved: an illegal move consumes NO draws (the reference
raises ``IllegalMove`` before ``add_tile``), so the caller must only
``draw()`` for steps that are legal.
"""

from __future__ import annotations

import numpy as np

_ALL_POSITIONS = [(r, c) for r in range(4) for c in range(4)]


def np_random(seed: int | None = None) -> tuple[np.random.Generator, int]:
    """``(generator, seed entropy)`` as ``gymnasium.utils.seeding.np_random``
    returns them: a PCG64 generator over ``SeedSequence(seed)``; ``None``
    draws the entropy fresh. ``seed`` must be a non-negative int."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative python int, got {seed!r}")
    seed_seq = np.random.SeedSequence(seed)
    return np.random.Generator(np.random.PCG64(seed_seq)), seed_seq.entropy


class ReferenceSpawnStream:
    """The spawn-decision stream of one reference env under a fixed seed.

    ``draw()`` consumes exactly what one ``add_tile`` call consumes and
    returns ``(val_exp, rank)``: the tile exponent (1 for a 2, 2 for a 4)
    and a ``(16,)`` array where ``rank[flat_cell]`` is the position of that
    cell in the shuffled visit order — ``rules.spawn_ranked`` places the
    tile at the empty cell of minimum rank, which is exactly "first empty
    position in shuffled order".
    """

    def __init__(self, seed: int):
        # the seeding path of gymnasium.Env.reset(seed=...), which the
        # reference relies on (game2048_env.py:102-103)
        self.rng, _ = np_random(seed)

    def draw(self) -> tuple[int, np.ndarray]:
        val_exp = 1 if self.rng.random() < 0.9 else 2
        positions = _ALL_POSITIONS.copy()
        self.rng.shuffle(positions)
        rank = np.empty(16, np.int32)
        for order, (r, c) in enumerate(positions):
            rank[4 * r + c] = order
        return val_exp, rank


def reset_draws(streams: list[ReferenceSpawnStream]):
    """Consume each stream's two reset spawns; returns ``(vals (B, 2) int8,
    ranks (B, 2, 16) int32)`` ready for ``batched.reset_parity``."""
    vals = np.zeros((len(streams), 2), np.int8)
    ranks = np.zeros((len(streams), 2, 16), np.int32)
    for b, s in enumerate(streams):
        for i in range(2):
            vals[b, i], ranks[b, i] = s.draw()
    return vals, ranks
