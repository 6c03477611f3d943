"""Entry ``play_policy``: one ``agents/expectimax.play_policy`` call of the
adaptive-depth agent over the n-tuple network (``make_adaptive_policy(
net.value_batch, k_deep, deep_empty_max)``), ``games`` games in lockstep.

Set-up draws the network's table from ``--seed`` on the card (one
``randn``, times ``table_scale``) and warms every shape with one call cut to
one chunk of moves. Call i of the window draws its spawns from a generator
seeded from ``--seed`` and i. Its work is the moves of live games.

The policy the window hands ``play_policy`` is the agent's, wrapped to keep
a reference to each lockstep move's boards, live mask and actions (no
device work). The check then, on a sample of ``check_moves`` lockstep moves
drawn from the seed, values every live board's moves with the plain agent
(``reference/search.py``, the same table made again from the seed) and
reads ``action_gap``: the widest amount by which the program's move lies
below the best, over the larger of 1 and the best's magnitude. And it
replays every call's games with the plain rules from the same generator
seed and the program's moves: ``game_mismatches`` counts boards that differ
from the program's at any move, and games whose score, length or highest
tile differ from what ``play_policy`` returned.
"""

from __future__ import annotations

import random

import torch

from benchmark.entries.base import Entry as Base
from benchmark.entries.base import reserve
from benchmark.harness import derive_seed
from benchmark.tracing import Span


class Entry(Base):
    rate_metric = "agent_moves_per_s"
    rate_unit = "moves/s"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from gym2048_tpu_torch.agents import expectimax
        from gym2048_tpu_torch.models import ntuple_big

        c, t = self.config, self.traffic
        if [list(x) for x in ntuple_big.LAYOUTS[c["arch"]]] != c["tuples"]:
            raise ValueError(f"layout {c['arch']} is not the configuration's tuples")
        self.expectimax = expectimax
        self.net = ntuple_big.make_network(c["arch"], c["n_vals"], tuple(c["thresholds"]))
        self.policy = expectimax.make_adaptive_policy(self.net.value_batch, t["k_deep"],
                                                      t["deep_empty_max"])
        self.table = None
        self.calls = []  # per call: (generator seed, moves [(boards, live, action)], result)
        self.moves = None
        self.steps_per_unit = 0

    def make_table(self, dtype=torch.float32) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "table"))
        table = torch.randn(self.net.table_size, generator=gen, device=self.device)
        return table.mul_(self.traffic["table_scale"]).to(dtype)

    def _recording_policy(self, params, boards, live):
        action = self.policy(params, boards, live)
        if self.moves is not None:
            self.moves.append((boards, live, action))
        return action

    def _play(self, gen_seed: int, move_cap: int):
        t = self.traffic
        gen = torch.Generator(device=self.device).manual_seed(gen_seed)
        return self.expectimax.play_policy(
            self._recording_policy, t["games"], gen, move_cap, t["chunk_moves"],
            params=self.table, needs_active=True, device=self.device)

    def setup(self):
        self.table = self.make_table()
        self._play(derive_seed(self.seed, "warm"), self.traffic["chunk_moves"])

    def unit(self) -> float:
        gen_seed = derive_seed(self.seed, f"call {len(self.calls)}")
        self.moves = []
        result = self._play(gen_seed, self.traffic["move_cap"])
        self.calls.append((gen_seed, self.moves, result))
        self.steps_per_unit = len(self.moves)
        self.moves = None
        return float(sum(e["moves"] for e in result["Episodes"]))

    def release(self):
        self.table = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- trace
    def spans(self):
        from gym2048_tpu_torch.models import ntuple_big

        self.stash = {"gather_idx": []}
        # the window's lookups: ~84,000 indices of 4 bytes a board a lockstep move
        # (its depth-2 leaves, and depth 3 for k_deep boards)
        reserve(self.device, self.traffic["trace_moves"] * self.traffic["games"] * 84_000 * 4
                * 5 // 4)
        keep = lambda args, kwargs, out: self.stash["gather_idx"].append(
            (self._traced_move, args[1]))
        return [Span(ntuple_big, "gather_values", "gather_values", keep)]

    def traced_units(self, start, stop):
        """The first ``trace_moves`` lockstep moves of one call, from the
        call's start (a whole number of the host's 128-move chunks)."""
        limit = int(self.traffic["trace_moves"])
        self._traced_move = 0
        inner = self._recording_policy

        def counting(params, boards, live):
            if self._traced_move == 0:
                start()
            elif self._traced_move == limit:
                stop()
            self._traced_move += 1
            return inner(params, boards, live)

        self._recording_policy = counting
        try:
            self.unit()
        finally:
            del self._recording_policy
        if self._traced_move <= limit:
            stop()
        return 1, float(min(limit, self._traced_move))

    # ---------------------------------------------------------------- check
    def calibration_units(self) -> None:
        self.unit()

    def control(self):
        """The control in the program's place: at the positions of one call
        of the program, the moves that the plain agent over the table in
        bfloat16 values best."""
        self.setup()
        self.unit()
        table = self.make_table(torch.bfloat16)
        value = lambda boards: self._ref_net().values(table, boards)
        calls = []
        for gen_seed, moves, result in self.calls:
            picked = [(b, live, self._ref_values(value, b, live).argmax(-1)) for b, live, _ in moves]
            calls.append((gen_seed, picked, result))
        self.calls = calls
        self.release()
        self.replay_games = False

    def _ref_net(self):
        from benchmark.reference.ntuple import Network

        c = self.config
        return Network(c["tuples"], c["n_vals"], c["thresholds"], self.device)

    def _ref_values(self, value, boards, live):
        from benchmark.reference.search import adaptive_values

        t = self.traffic
        return adaptive_values(value, boards, live, t["k_deep"], t["deep_empty_max"])

    def action_gap(self) -> float:
        net = self._ref_net()
        table = self.make_table()
        value = lambda boards: net.values(table, boards)
        moves = [(c, m) for c, (_, ms, _) in enumerate(self.calls) for m in range(len(ms))]
        rng = random.Random(derive_seed(self.seed, "check moves"))
        picked = rng.sample(moves, min(len(moves), int(self.traffic["check_moves"])))
        worst = 0.0
        for c, m in picked:
            boards, live, action = self.calls[c][1][m]
            q = self._ref_values(value, boards, live)
            best = q.amax(-1)
            mine = q.gather(1, action.to(torch.int64)[:, None])[:, 0]
            gap = (best - mine) / best.abs().clamp(min=1.0)
            if bool(live.any()):
                worst = max(worst, float(gap[live].max()))
        return worst

    def game_mismatches(self) -> int:
        from benchmark.reference import rules

        bad = 0
        games = self.traffic["games"]
        for gen_seed, moves, result in self.calls:
            gen = torch.Generator(device=self.device).manual_seed(gen_seed)
            board = rules.fresh_boards(torch.rand((games, 4), generator=gen, device=self.device))
            score = torch.zeros(games, dtype=torch.float32, device=self.device)
            steps = torch.zeros(games, dtype=torch.int64, device=self.device)
            total = torch.zeros_like(score)
            count = torch.zeros_like(steps)
            high = torch.zeros_like(steps)
            live = torch.ones(games, dtype=torch.bool, device=self.device)
            for boards, _, action in moves:
                bad += int((boards != board).reshape(games, 16).any(-1).sum())
                u = torch.rand((games, 6), generator=gen, device=self.device)
                board, score, steps, reward, ended, top, _, _ = rules.env_step(
                    board, score, steps, action, u, auto_reset=False)
                total += torch.where(live, reward, 0.0)
                count += live.to(torch.int64)
                high = torch.where(live, top, high)
                live = live & ~ended
            for g, e in enumerate(result["Episodes"]):
                bad += int(e["total_reward"] != float(total[g]) or e["moves"] != int(count[g])
                           or e["highest"] != int(high[g]))
        return bad

    def check(self):
        readings = {"action_gap": self.action_gap()}
        if getattr(self, "replay_games", True):
            readings["game_mismatches"] = float(self.game_mismatches())
        return self.numbers(readings)
