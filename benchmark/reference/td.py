"""TD(0) afterstate learning with delayed temporal coherence, written plainly.

The learner of Jaskowski, "Mastering 2048 with Delayed Temporal Coherence
Learning, Multi-Stage Weight Promotion, Redundant Encoding and Carousel
Shaping" (arXiv:1604.05085), over :class:`~benchmark.reference.ntuple.Network`.
Every env plays the greedy afterstate move, argmax over legal moves of
``reward + V(afterstate)`` (the first on ties), and the afterstate chosen
one step earlier learns towards ``reward + V(afterstate)`` of this step (0
when no move is left). Each of its features' entries collects the
occurrence's update ``delta / 4`` (a board's 32 features carry 8 times its
value): the sum, the sum of magnitudes and the count, for ``tc_every``
steps; then every touched entry moves by ``alpha * |E| / A * (sum /
count)``, where E and A are the entry's running signed and absolute sums
after adding this window's (the rate is 1 while A is 0). A finished game
restarts from a fresh board, or with probability ``carousel`` from a board
recorded when some game entered a higher stage (the carousel).

The uniforms are drawn from a ``torch.Generator`` in the order of the
learner under test: ``(n_envs, 4)`` for the first boards, then ``(10,
n_envs)`` a step: spawn value, spawn position, four for a fresh board, the
carousel's record slot, use, stage and slot. The same generator seed gives
the same numbers, so the two learners play the same games as far as their
arithmetic agrees.

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference import rules
from benchmark.reference.ntuple import Network


class Learner:
    """The learner of a configuration (``config``: tuples, n_vals,
    thresholds) and a traffic (``traffic``: n_envs, chunk_steps, tc_every,
    alpha, carousel, carousel_slots), its tables in ``dtype``."""

    def __init__(self, config: dict, traffic: dict, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        self.dev = generator.device
        self.net = Network(config["tuples"], config["n_vals"], config["thresholds"], self.dev)
        self.t = traffic
        self.gen = generator
        self.dtype = dtype
        n = traffic["n_envs"]
        size = self.net.size
        self.table = torch.full((size,), float(traffic["init_value"]) / len(config["tuples"]),
                                dtype=dtype, device=self.dev)
        self.tc_e = torch.zeros(size, dtype=dtype, device=self.dev)
        self.tc_a = torch.zeros(size, dtype=dtype, device=self.dev)
        self.boards = rules.fresh_boards(torch.rand((n, 4), generator=generator, device=self.dev))
        self.prev_after = torch.zeros_like(self.boards)
        self.prev_v = torch.zeros(n, dtype=dtype, device=self.dev)
        self.prev_valid = torch.zeros(n, dtype=torch.bool, device=self.dev)
        stages = len(config["thresholds"]) + 1
        self.car_b = torch.zeros((stages, traffic["carousel_slots"], 4, 4), dtype=torch.int8,
                                 device=self.dev)
        self.car_f = torch.zeros((stages, traffic["carousel_slots"]), dtype=torch.bool,
                                 device=self.dev)

    def leaves(self) -> dict[str, torch.Tensor]:
        return {"table": self.table, "tc_e": self.tc_e, "tc_a": self.tc_a}

    def _greedy(self, boards):
        after_all, gain, legal = rules.move_all(boards)
        n = boards.shape[0]
        v = self.net.values(self.table, after_all.reshape(n * 4, 4, 4)).reshape(n, 4)
        q = torch.where(legal, gain.to(v.dtype) + v, -torch.inf)
        a = q.argmax(-1, keepdim=True)
        after = after_all.gather(1, a[:, :, None, None].expand(-1, 1, 4, 4))[:, 0]
        return after, gain.gather(1, a)[:, 0].to(v.dtype), v.gather(1, a)[:, 0], legal.any(-1)

    def _step(self, pending):
        t, n = self.t, self.boards.shape[0]
        u = torch.rand((10, n), generator=self.gen, device=self.dev)
        after, r, v_after, alive = self._greedy(self.boards)
        delta = torch.where(alive, r + v_after, 0.0) - self.prev_v
        keep = self.prev_valid
        idx = self.net.indices(self.prev_after[keep]).reshape(-1)
        w = (delta[keep] / 4.0)[:, None].expand(-1, self.net.n_features).reshape(-1)
        sums, absums, counts = pending
        sums.index_add_(0, idx, w)
        absums.index_add_(0, idx, w.abs())
        counts.index_add_(0, idx, torch.ones_like(w))

        nxt = rules.spawn(after, u[0], u[1])
        done = ~alive
        fresh = rules.fresh_boards(u[2:6].T)
        if t["carousel"]:
            slots = t["carousel_slots"]
            st0, st1 = self.net.stage(self.boards), self.net.stage(nxt)
            crossed = (st1 > st0) & alive
            row = torch.where(crossed, st1, 0)
            slot = (u[6] * slots).to(torch.int64)
            self.car_b = self.car_b.index_put((row, slot), nxt)
            self.car_f = self.car_f.index_put((row, slot), torch.tensor(True, device=self.dev))
            stages = self.car_f.shape[0]
            pick_s = 1 + (u[8] * (stages - 1)).to(torch.int64)
            pick_j = (u[9] * slots).to(torch.int64)
            ok = (u[7] < t["carousel"]) & self.car_f[pick_s, pick_j]
            fresh = torch.where(ok[:, None, None], self.car_b[pick_s, pick_j], fresh)
        self.boards = torch.where(done[:, None, None], fresh, nxt)
        self.prev_after, self.prev_v, self.prev_valid = after, v_after, alive

    def _combine(self, pending, alpha):
        sums, absums, counts = pending
        mean = sums / counts.clamp(min=1.0)
        self.tc_e = self.tc_e + sums
        self.tc_a = self.tc_a + absums
        rate = torch.where(self.tc_a > 0, self.tc_e.abs() / self.tc_a.clamp(min=1e-30), 1.0)
        self.table = self.table + alpha * rate * mean

    def chunk(self):
        """One chunk of ``chunk_steps`` steps, the TC combine after every
        ``tc_every``."""
        t = self.t
        k = t["tc_every"]
        for _ in range(t["chunk_steps"] // k):
            pending = tuple(torch.zeros_like(self.table) for _ in range(3))
            for _ in range(k):
                self._step(pending)
            self._combine(pending, t["alpha"])
