"""Entry ``td_chunk``: one ``TDTrainer.train_chunk`` of the n-tuple learner,
read once on the host as ``TDTrainer.learn`` reads a logged chunk.

Set-up builds the trainer from the configuration and the traffic, its
state from a generator seeded from ``--seed``, and runs the first
``check_units`` chunks through :meth:`Entry.unit`, reading after each the
norms of the learned leaves (``table``, ``tc_e``, ``tc_a``). The check runs
the plain learner (``reference/td.py``) from the same generator seed for as
many chunks and compares: ``first_gap``, the worst leaf's gap of norms after
the first chunk (the TC statistics as the first combines applied them), and
``change_gap``, the same for the change of each leaf after the last. The
learner computes no loss to compare.

A traced run starts with :func:`sample_steps` on the learner's state,
outside the window: the lookup and TC work of the steps that the window
then plays, counted with the plain reference from the same boards and
draws, which ``gather_roofline.td`` and ``step_mfu.td`` read. No wrapper
sits around a function of the program.
"""

from __future__ import annotations

import torch

from benchmark.entries.base import Entry as Base
from benchmark.entries.base import leaf_gap, norm64
from benchmark.harness import derive_seed

LEAVES = ("table", "tc_e", "tc_a")


def sample_steps(config: dict, state: dict, steps: int, window: int) -> dict:
    """The work of ``steps`` greedy steps from a TD learner's ``state``,
    played with the plain reference (``reference/rules.py``,
    ``reference/ntuple.py``) and no update: it reads ``state["boards"]``,
    ``state["table"]`` and a copy of ``state["generator"]``, draws each
    step's uniforms as the learner does (10 rows with the carousel, else
    6), spawns after each move and restarts a finished game from a fresh
    board. So it plays the learner's next steps on the same boards and
    draws, apart from moves that the learner's TC combines (every
    ``window`` steps) change and the carousel's restarts (a few boards in a
    thousand). Returns ``lookup_indices`` and ``lookup_sectors``, each
    step's indices into the table and their distinct 32-byte sectors (all
    four afterstates of every board), and ``chosen_sectors``, for each
    ``window`` steps the distinct sectors that their chosen afterstates of
    boards with a legal move address together: what a TC window's updates
    touch."""
    from benchmark import counts
    from benchmark.reference import rules
    from benchmark.reference.ntuple import Network

    boards, table = state["boards"], state["table"]
    dev, n = boards.device, boards.shape[0]
    net = Network(config["tuples"], config["n_vals"], config["thresholds"], dev)
    gen = torch.Generator(device=dev)
    gen.set_state(state["generator"].get_state())
    rows = 10 if "car_boards" in state else 6
    n_idx, sectors, chosen_sectors, chosen = [], [], [], []
    for t in range(steps):
        u = torch.rand((rows, n), generator=gen, device=dev)
        after_all, gain, legal = rules.move_all(boards)
        idx = net.indices(after_all.reshape(n * 4, 4, 4))
        n_idx.append(idx.numel())
        sectors.append(counts.distinct_sectors(idx))
        v = (table[idx].sum(-1) / 8.0).reshape(n, 4)
        q = torch.where(legal, gain.to(v.dtype) + v, -torch.inf)
        a = q.argmax(-1, keepdim=True)
        after = after_all.gather(1, a[:, :, None, None].expand(-1, 1, 4, 4))[:, 0]
        alive = legal.any(-1)
        chosen.append(net.indices(after[alive]).reshape(-1))
        if (t + 1) % window == 0:
            chosen_sectors.append(counts.distinct_sectors(torch.cat(chosen)))
            chosen = []
        nxt = rules.spawn(after, u[0], u[1])
        boards = torch.where(alive[:, None, None], nxt, rules.fresh_boards(u[2:6].T))
    return {"lookup_indices": n_idx, "lookup_sectors": sectors,
            "chosen_sectors": chosen_sectors}


class Entry(Base):
    rate_metric = "td_steps_per_s"
    rate_unit = "steps/s"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from gym2048_tpu_torch.models import ntuple_big
        from gym2048_tpu_torch.train import td

        c, t = self.config, self.traffic
        layout = [list(x) for x in ntuple_big.LAYOUTS[c["arch"]]]
        if layout != c["tuples"]:
            raise ValueError(f"layout {c['arch']} is not the configuration's tuples")
        self.td = td
        self.cfg = td.TDConfig(
            total_steps=10 ** 15, n_envs=t["n_envs"], alpha=t["alpha"], alpha_final=t["alpha"],
            init_value=t["init_value"], seed=0, chunk_steps=t["chunk_steps"],
            update_impl=t["update_impl"], value_impl=t["value_impl"], tc=t["tc"],
            arch=c["arch"], n_vals=c["n_vals"], thresholds=tuple(c["thresholds"]),
            tc_every=t["tc_every"], carousel=t["carousel"], carousel_slots=t["carousel_slots"])
        self.steps_per_unit = t["chunk_steps"]
        self.gen_seed = derive_seed(seed, "td")
        self.trainer = None
        self.state = None
        self.sample = None

    def _readings(self, state) -> dict:
        init = self.traffic["init_value"] / len(self.config["tuples"])
        return {k: norm64(state[k] - (init if k == "table" else 0.0)) for k in LEAVES}

    def setup(self):
        self.trainer = self.td.TDTrainer(self.cfg, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        self.state = self.trainer.init_state(gen)
        self.readings = []
        for _ in range(self.traffic["check_units"]):
            self.unit()
            self.readings.append(self._readings(self.state))

    def unit(self) -> float:
        self.state, m = self.trainer.train_chunk(self.state, self.traffic["alpha"])
        float(m["episodes"])
        return float(self.cfg.n_envs * self.cfg.chunk_steps)

    def release(self):
        self.state = self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- trace
    def traced_units(self, start, stop):
        """The work sample of the steps that the traced window plays
        (:func:`sample_steps` from the state they start from, before the
        window), then the window."""
        steps = int(self.traffic["trace_units"]) * self.steps_per_unit
        self.sample = sample_steps(self.config, self.state, steps, self.traffic["tc_every"])
        return super().traced_units(start, stop)

    # ---------------------------------------------------------------- check
    def reference_readings(self, dtype=torch.float32) -> list[dict]:
        """The plain learner's readings after each of the first chunks."""
        from benchmark.reference.td import Learner

        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        ref = Learner(self.config, self.traffic, gen, dtype)
        init = self.traffic["init_value"] / len(self.config["tuples"])
        out = []
        for _ in range(self.traffic["check_units"]):
            ref.chunk()
            out.append({k: norm64(v.float() - (init if k == "table" else 0.0))
                        for k, v in ref.leaves().items()})
        del ref
        return out

    def control(self) -> None:
        """The control in the program's place: the plain learner with its
        tables and sums in bfloat16, the precision below the configuration's
        float32."""
        self.readings = self.reference_readings(torch.bfloat16)

    def compare(self, program: list[dict], reference: list[dict]) -> dict:
        return {"first_gap": leaf_gap(program[0], reference[0]),
                "change_gap": leaf_gap(program[-1], reference[-1])}

    def check(self):
        return self.numbers(self.compare(self.readings, self.reference_readings()))
