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
"""

from __future__ import annotations

import torch

from benchmark.entries.base import Entry as Base
from benchmark.entries.base import leaf_gap, norm64, reserve
from benchmark.harness import derive_seed
from benchmark.tracing import Span

LEAVES = ("table", "tc_e", "tc_a")


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
    def spans(self):
        from gym2048_tpu_torch.models import ntuple_big

        self.stash = {"gather_idx": [], "greedy": []}
        # the window's lookups: 4 bytes for each of 4 x 32 indices an env a step
        reserve(self.device, self.traffic["trace_units"] * self.cfg.chunk_steps
                * self.cfg.n_envs * 4 * 32 * 4 * 5 // 4)
        keep_idx = lambda args, kwargs, out: self.stash["gather_idx"].append(
            (len(self.stash["greedy"]), args[1]))
        keep_greedy = lambda args, kwargs, out: self.stash["greedy"].append((out[1], out[4]))
        return [Span(self.td, "_tc_combine", "tc_combine"),
                Span(self.td, "_greedy_batch", "greedy", keep_greedy),
                Span(ntuple_big, "gather_values", "gather_values", keep_idx)]

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
