#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of gym2048_tpu on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA sources under ``gym2048_tpu_torch/csrc/`` with one
``nvcc`` each, all started together, and holds every kernel against its
plain PyTorch version on the card (bit for bit). Then it drives four
paths, each between zeroed launch counters and reported with its own
counts:

* the self-play engine at the repository's headline size (1,048,576
  boards stepped 1024 times in one rollout launch, ``bench.py::bench_pallas``),
  checked by random-play statistics;
* a step-by-step replay of 65,536 of those boards through the single-step
  kernels;
* the n-tuple agent: the flagship adaptive depth-3 afterstate expectimax
  over the staged 4x6 network at full width (201,326,592 f32 entries, made
  on the card from a seed), whose every value lookup is the table gather
  kernel; its first 128 moves are replayed with the plain lookup and must
  be identical;
* the flagship TD learner (``train/td.py``): the config of
  ``docs/curves/ntuple_4x6_tc_r5.meta.json`` at full width (8192 envs,
  the staged 4x6 table with its TC accumulators, delayed TC every 8 steps,
  carousel 0.5), one 64-step chunk, one lookup kernel launch per step. A
  16-step chunk is replayed with the plain lookup in deterministic mode and
  must leave every leaf of the state identical; the learner's rate is
  measured in two configs, profiled, and checked to learn: 50 chunks of the
  unstaged 4x6 TC config of ``docs/curves/td_4x6_tc_run.jsonl`` must reach
  an episode score inside the band that the JAX runs bracket.

Each phase prints one line with its seconds; any failed check raises, so
the exit code is non-zero. Without CUDA it exits non-zero before printing
any result: it never runs on the CPU.

The last lines of standard output are the card's name and power limit as
``nvidia-smi`` reports them, one JSON object with each kernel's launches,
error, times and bound, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

sys.dont_write_bytecode = True  # the run writes nothing into the tree but build/

import numpy as np
import torch

SEED = 5
FULL_B = 1 << 20          # bench.py PALLAS_BATCH
FULL_T = 1024             # bench.py T_LARGE
FULL_BLOCK = 8192         # bench.py PALLAS_BLOCK
SMALL_B = 65536           # bench.py BATCH: the single-step kernels and the env
TIMED_RUNS = 5            # bench.py SAMPLES

# Published H100 SXM peaks: 3.35 TB/s of HBM; an SM issues at most four
# warp instructions (128 thread instructions) per clock whatever their type,
# 132 SMs x 128 x 1.98 GHz, the same rate as its 67 TFLOP/s of f32 FMA.
# The step kernels are integer work; their instructions per thread are
# counted in the SASS of the built library (gym2048_tpu_torch/_sass.py:
# the shortest path a thread can take, so the bound is a lower bound).
MEM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 132 * 128 * 1.98e9

FUSED_SOURCE = "gym2048_tpu_torch/csrc/fused_step.cu"
GATHER_SOURCE = "gym2048_tpu_torch/csrc/table_gather.cu"
# kernel -> (the TPU kernel it replaces, its source, its kernel in the SASS)
KERNELS = {
    "fused_rollout": ("gym2048_tpu/core/pallas_step.py:414", FUSED_SOURCE,
                      "fused_rollout_kernel"),
    "fused_step_uniform": ("gym2048_tpu/core/pallas_step.py:311", FUSED_SOURCE,
                           "fused_step_uniform_kernel"),
    "fused_move": ("gym2048_tpu/core/pallas_step.py:357", FUSED_SOURCE,
                   "fused_move_kernel"),
    "random_uniform_rows": ("scripts/tpu_pallas_stats.py:42", FUSED_SOURCE,
                            "random_uniform_rows_kernel"),
    "gather_values": ("gym2048_tpu/models/pallas_table.py:101", GATHER_SOURCE,
                      "gather4_kernel"),
}
# The paths that drive the kernels, each read with its own launch counts:
# the engine's rollout, the step-by-step replay that runs the single-step
# kernels on the rollout's own uniforms, and the n-tuple agent.
PATHS = {
    "rollout": ("fused_rollout",),
    "step replay": ("fused_step_uniform", "fused_move", "random_uniform_rows"),
    "agent": ("gather_values",),
    "td": ("gather_values",),
}

# The flagship agent (docs/curves/ntuple_4x6_tc_r5.meta.json and
# td_4x6_tc_r5_adaptive_d3_eval.json): 4x6 layout, n_vals 16, stages at
# exponents 12 and 13, adaptive depth 3 with k_deep 8 and deep_empty_max 8,
# 64 games. The table is normal values x 100 (score units) from SEED: the
# committed trained table is not read here.
AGENT_ARCH, AGENT_N_VALS, AGENT_THRESHOLDS = "4x6", 16, (12, 13)
AGENT_GAMES, AGENT_K_DEEP, AGENT_EMPTY_MAX = 64, 8, 8
AGENT_MOVE_CAP = 1024      # lockstep moves, so the phase stays near 30 s
AGENT_CHUNK = 128
REPLAY_MOVES = 128         # moves replayed with the plain lookup
GATHER_UNIFORM_N = 1 << 23
LEAF_BOARDS = 512          # boards whose depth-2 leaves make the real stream
TIMING_GAMES = 512         # README: --episodes 512 --depth 2

# The flagship learner: docs/curves/ntuple_4x6_tc_r5.meta.json's config,
# total_steps excepted (the trainer takes chunks, not a total, here).
TD_FLAGSHIP = dict(n_envs=8192, alpha=1.0, alpha_final=1.0, init_value=0.0, seed=7,
                   chunk_steps=64, update_impl="auto", value_impl="auto", tc=True,
                   arch="4x6", n_vals=16, thresholds=(12, 13), tc_every=8,
                   carousel=0.5, carousel_slots=256)
# bench.py::bench_td_big: 8192 envs x 16 steps, 4x6, TC, unstaged
TD_BENCH_BIG = dict(n_envs=8192, chunk_steps=16, arch="4x6", tc=True, alpha=1.0,
                    alpha_final=1.0, init_value=0.0)
# docs/curves/td_4x6_tc_run.jsonl: 4x6, TC, unstaged, 8192 envs, alpha 1,
# init 0; its first line is at 26,214,400 steps = 50 chunks x 64 x 8192
TD_LEARN = dict(n_envs=8192, chunk_steps=64, arch="4x6", tc=True, alpha=1.0,
                alpha_final=1.0, init_value=0.0, seed=SEED, total_steps=26_214_400)
# The JAX runs logged 41,377 and 44,870 there (td_4x6_tc_r4_run.jsonl,
# td_4x6_tc_run.jsonl); random play scores ~1,000.
TD_LEARN_BAND = (24_800.0, 65_000.0)
TD_REPLAY_STEPS = 16       # the deterministic kernel-vs-plain chunk
TD_TIMED_CHUNKS = 3

PHILOX_KAT = [  # Random123 known answers: counter, key, result
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_abs_err(got, want) -> float:
    """Largest |got - want| over tensors of equal shape and dtype."""
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def event_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` in ms over ``reps`` calls made from Python, after a
    warm-up: the device's time, or the host's where it issues work slower."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in one
    CUDA graph and replayed between two events, which leaves out the host's
    cost of each call (checks, allocation, the ctypes call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for ``ops`` thread instructions and ``nbytes`` of
    memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = ops / ISSUE_PER_S * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_boards(rng, n: int, max_exp: int, p_zero: float) -> np.ndarray:
    exps = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def leaf_afterstates(boards: torch.Tensor) -> torch.Tensor:
    """The depth-2 leaf afterstates of ``(B, 4, 4)`` boards, ``(B * 512, 4, 4)``:
    each move's afterstate, each of its 32 spawn children, each child's 4
    moves. These are the boards whose values the last level of a depth-2
    afterstate search reads (illegal moves and impossible spawns included,
    as the search evaluates them)."""
    from gym2048_tpu_torch.agents.expectimax import spawn_children
    from gym2048_tpu_torch.core import rules

    b = boards.shape[0]
    moved = rules.move_all(boards)[0].reshape(b * 4, 4, 4)
    children = spawn_children(moved)[0].reshape(b * 128, 4, 4)
    return rules.move_all(children)[0].reshape(b * 512, 4, 4)


def plain_value_fn(net):
    """``net.value_batch`` with the plain lookup in place of the kernel."""
    from gym2048_tpu_torch.models.table_gather import gather_values_reference

    def value(table, boards):
        idx = net.indices_batch(boards)
        return gather_values_reference(table, idx.reshape(-1)).reshape(idx.shape).sum(-1) / 8.0

    return value


class MoveRecord:
    """Wraps an adaptive ``policy(params, boards, active)`` and keeps each
    move's boards, live mask and actions on the device; :meth:`replay`
    checks and scores them after the run, outside the timed region."""

    def __init__(self, policy):
        self.policy = policy
        self.boards: list[torch.Tensor] = []
        self.active: list[torch.Tensor] = []
        self.actions: list[torch.Tensor] = []

    def __call__(self, params, boards, active):
        a = self.policy(params, boards, active)
        self.boards.append(boards)
        self.active.append(active)
        self.actions.append(a)
        return a

    def replay(self, moves: int):
        """Over the first ``moves`` moves: the number of live boards given an
        illegal action, and each game's score and length."""
        from gym2048_tpu_torch.core import rules

        boards = torch.stack(self.boards[:moves])
        live = torch.stack(self.active[:moves])
        col = torch.stack(self.actions[:moves]).long()[..., None]
        _, scores, legal = rules.move_all(boards)
        illegal = (live & ~legal.gather(-1, col)[..., 0]).sum().item()
        score = torch.where(live, scores.gather(-1, col)[..., 0], 0).sum(0)
        return illegal, score.tolist(), live.sum(0).tolist()


def clone_state(state: dict) -> dict:
    """A copy of a TD train state that training the original does not touch,
    its generator included."""
    out = {k: v.clone() for k, v in state.items() if k != "generator"}
    gen = state["generator"]
    out["generator"] = torch.Generator(device=gen.device)
    out["generator"].set_state(gen.get_state())
    return out


def state_diffs(a: dict, b: dict) -> list[str]:
    """The leaves of two TD train states that are not equal bit for bit."""
    check(set(a) == set(b), f"state keys {sorted(a)} vs {sorted(b)}")
    bad = [k for k in a if k != "generator" and not torch.equal(
        a[k].view(torch.int32) if a[k].dtype == torch.float32 else a[k],
        b[k].view(torch.int32) if b[k].dtype == torch.float32 else b[k])]
    if not torch.equal(a["generator"].get_state(), b["generator"].get_state()):
        bad.append("generator")
    return bad


def short_kernel_name(key: str) -> str:
    """A profiler kernel name without its return type and namespaces."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::"):
        key = key.replace(noise, "")
    return key[:110]


@contextlib.contextmanager
def plain_lookup():
    """Within this block the network's lookup is the plain version
    (``torch.take``) instead of the kernel."""
    from gym2048_tpu_torch.models import ntuple_big, table_gather

    saved = ntuple_big.gather_values
    ntuple_big.gather_values = table_gather.gather_values_reference
    try:
        yield
    finally:
        ntuple_big.gather_values = saved


def timed_chunks(trainer, state, chunks: int):
    """Run ``chunks`` chunks after the given state, each host-timed to a
    device sync; returns the state, the seconds of each, and the last
    chunk's metrics."""
    secs = []
    for _ in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_chunk(state, 1.0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return state, secs, metrics


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    """The phases of one run; ``self.kernels`` collects the JSON record."""

    def __init__(self):
        from gym2048_tpu_torch.core import fused_step
        from gym2048_tpu_torch.models import table_gather

        self.fs = fused_step
        self.tg = table_gather
        self.counters = (fused_step.LAUNCHES, table_gather.LAUNCHES)
        self.dev = torch.device("cuda")
        self.kernels = {name: {"name": name, "route": "cuda", "source": source,
                               "replaces": where, "library_ms": None}
                        for name, (where, source, _) in KERNELS.items()}
        self.rng = np.random.default_rng(SEED)
        self.path_launches: dict[str, dict[str, int]] = {}
        self.run_launches = {name: 0 for c in self.counters for name in c}

    def run(self, num: str, name: str, fn) -> None:
        t0 = time.perf_counter()
        detail = fn()
        torch.cuda.synchronize()
        print(f"phase {num:>3} {name}: {detail} [{time.perf_counter() - t0:.2f} s]",
              flush=True)

    def launches(self) -> dict[str, int]:
        return {name: n for c in self.counters for name, n in c.items()}

    def zero_launches(self) -> None:
        for c in self.counters:
            for name, count in c.items():
                self.run_launches[name] += count
                c[name] = 0

    def drive(self, path: str, fn):
        """Run ``fn``, one path, between zeroed launch counts; record the
        counts it made and check that it launched each of its kernels."""
        self.zero_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = self.launches()
        self.zero_launches()
        self.path_launches[path] = counts
        for name in PATHS[path]:
            check(counts[name] > 0, f"{name} was not launched on the {path} path")
            self.kernels[name]["launches"] = counts[name]
        return out

    # 1
    def device(self) -> str:
        self.smi = nvidia_smi_line()
        return (f"{torch.cuda.get_device_name(0)}; nvidia-smi: {self.smi}; "
                f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2
    def build(self) -> str:
        from gym2048_tpu_torch import _build

        from gym2048_tpu_torch import _sass

        paths = _build.build_all()
        self.issue = {}
        for name, path in paths.items():
            _build.library(name)
            self.issue.update(_sass.issue_counts(_sass.dump(path)))
        counts = {name: self.issue[sass] for name, (_, _, sass) in KERNELS.items()}
        return (f"{', '.join(p.name for p in paths.values())}, one nvcc "
                f"{' '.join(_build.NVCC_FLAGS)} per source, started together; "
                f"fewest SASS instructions per thread "
                + ", ".join(f"{k} {c.outside}" + (f" + {c.per_iteration}/step"
                                                  if c.per_iteration else "")
                            for k, c in counts.items())
                + f"; gather1_kernel {self.issue['gather1_kernel'].outside}")

    def ops(self, kernel: str, threads: int, iterations: int = 0) -> int:
        """Thread instructions ``threads`` threads of ``kernel`` issue at least."""
        return threads * self.issue[KERNELS[kernel][2]].per_thread(iterations)

    # 3
    def philox(self) -> str:
        ctr = torch.tensor([k[0] for k in PHILOX_KAT], dtype=torch.int64, device=self.dev)
        key = torch.tensor([k[1] for k in PHILOX_KAT], dtype=torch.int64, device=self.dev)
        got = self.fs.philox4x32(ctr, key)
        check(got.tolist() == [list(k[2]) for k in PHILOX_KAT], f"Philox KAT {got.tolist()}")
        check(torch.equal(got, self.fs.philox4x32_reference(ctr, key)), "Philox vs plain")
        return "3 Random123 known answers match, kernel == plain"

    # 4
    def fused_move(self) -> str:
        fs = self.fs
        boards = torch.as_tensor(random_boards(self.rng, SMALL_B, 17, 0.35), device=self.dev)
        cm = fs.to_cell_major(boards)
        err = 0.0
        for a in range(4):
            act = torch.full((SMALL_B,), a, dtype=torch.int32, device=self.dev)
            err = max(err, max_abs_err(fs.fused_move(cm, act), fs.fused_move_reference(cm, act)))
        check(err == 0.0, f"fused_move differs from plain by {err}")
        self.kernels["fused_move"]["max_abs_err"] = err
        act = torch.as_tensor(self.rng.integers(0, 4, SMALL_B, dtype=np.int32), device=self.dev)
        rec = self.kernels["fused_move"]
        rec["ms"] = graph_ms(lambda: fs.fused_move(cm, act), 100)
        call_ms = event_ms(lambda: fs.fused_move(cm, act), 100)
        rec["plain_ms"] = event_ms(lambda: fs.fused_move_reference(cm, act), 5)
        # read: board, action; write: board, score, legal
        rec["bound_ms"], rec["bound_by"] = bound(self.ops("fused_move", SMALL_B),
                                                 SMALL_B * (64 + 4 + 64 + 4 + 4))
        return (f"{SMALL_B} boards, exponents 0-17, 4 actions: bit-exact (tolerance 0); "
                f"kernel {rec['ms']:.4f} ms on the device, {call_ms:.4f} ms per call "
                f"from Python; plain {rec['plain_ms']:.3f} ms")

    # 5
    def fused_step_uniform(self) -> str:
        fs = self.fs
        boards = random_boards(self.rng, SMALL_B, 12, 0.4)
        boards[:64] = np.array([[1, 2, 3, 4], [5, 6, 7, 8]] * 2, np.int8)  # dead
        cm = fs.to_cell_major(torch.as_tensor(boards, device=self.dev))
        u = torch.as_tensor(self.rng.random((8, SMALL_B), dtype=np.float32), device=self.dev)
        err, finished = 0.0, []
        for mte in (0, 11):
            got = fs.fused_step_uniform(cm, u, max_tile_exp=mte)
            want = fs.fused_step_uniform_reference(cm, u, mte)
            err = max(err, max_abs_err(got, want))
            finished.append(int(got[2].sum().item()))
        wins = finished[1] - finished[0]
        check(err == 0.0, f"fused_step_uniform differs from plain by {err}")
        self.kernels["fused_step_uniform"]["max_abs_err"] = err
        check(wins > 0, "no board won with max_tile_exp=11")
        rec = self.kernels["fused_step_uniform"]
        rec["ms"] = graph_ms(lambda: fs.fused_step_uniform(cm, u), 100)
        call_ms = event_ms(lambda: fs.fused_step_uniform(cm, u), 100)
        rec["plain_ms"] = event_ms(lambda: fs.fused_step_uniform_reference(cm, u), 5)
        # read: board and u rows 0-2, rows 3-4 only where a board resets
        # (max_tile_exp 0, as timed); write: board, score, finished, action
        nbytes = SMALL_B * (64 + 12 + 64 + 12) + finished[0] * 8
        rec["bound_ms"], rec["bound_by"] = bound(self.ops("fused_step_uniform", SMALL_B), nbytes)
        return (f"{SMALL_B} boards, max_tile_exp 0 and 11 ({wins} won): bit-exact "
                f"(tolerance 0); kernel {rec['ms']:.4f} ms on the device, {call_ms:.4f} ms "
                f"per call from Python; plain {rec['plain_ms']:.3f} ms")

    # 6
    def fused_rollout_small(self) -> str:
        fs = self.fs
        cm = fs.to_cell_major(torch.as_tensor(
            random_boards(self.rng, 4096, 6, 0.6), device=self.dev))
        got = fs.fused_rollout(cm, SEED, 64, 1024)
        t0 = time.perf_counter()
        want = fs.fused_rollout_reference(cm, SEED, 64)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max_abs_err(got, want)
        check(err == 0.0, f"fused_rollout differs from plain by {err}")
        return f"B=4096 T=64: bit-exact in all 4 outputs; plain {plain_s * 1e3:.1f} ms"

    # 7
    def random_uniform_rows_small(self) -> str:
        fs = self.fs
        u = fs.random_uniform_rows(123, (64, 4096), self.dev)
        err = max_abs_err([u], [fs.random_uniform_rows_reference(123, (64, 4096), self.dev)])
        check(err == 0.0, f"random_uniform_rows differs from plain by {err}")
        x = u.double().reshape(-1)
        mean = x.mean().item()
        check(0.495 < mean < 0.505, f"uniform mean {mean}")
        check(x.min().item() >= 0.0 and x.max().item() < 1.0, "uniforms outside [0, 1)")
        hist = torch.histc(x, bins=16, min=0.0, max=1.0) / x.numel()
        dev = (hist - 1 / 16).abs().max().item()
        check(dev < 0.005, f"histogram max |p - 1/16| = {dev}")
        return f"(64, 4096): bit-exact; mean {mean:.5f}, histogram max |p - 1/16| {dev:.5f}"

    # 8a
    def main_path(self) -> str:
        """The engine at full size: one rollout launch over 1,048,576 boards
        and 1024 steps from empty boards, checked by random-play statistics."""
        fs = self.fs
        zeros = torch.zeros((16, FULL_B), dtype=torch.int32, device=self.dev)
        board, score, episodes, total = self.drive(
            "rollout", lambda: fs.fused_rollout(zeros, SEED, FULL_T, FULL_BLOCK))
        eps = episodes.sum().item()
        ep_len = FULL_T * FULL_B / max(eps, 1)
        per_step = total.double().mean().item() / FULL_T
        distinct = torch.unique(board.T, dim=0).shape[0]
        check(100 < ep_len < 150, f"episode length {ep_len}")
        check(8.0 < per_step < 10.5, f"score per step {per_step}")
        check(distinct > 0.9 * FULL_B, f"{distinct} distinct final boards")
        self.full_out = (board, score, episodes, total)
        self.leaf_roots = fs.from_cell_major(board[:, :LEAF_BOARDS].contiguous())
        return (f"rollout B={FULL_B} T={FULL_T}: episode length {ep_len:.2f}, "
                f"score/step {per_step:.3f}, {distinct} distinct boards; "
                f"launches {self.path_launches['rollout']}")

    # 8b
    def step_replay(self) -> str:
        """The first 65,536 boards of the rollout replayed step by step from
        its own generator, each step's move checked by fused_move; the
        replay must end on the rollout's outputs exactly."""
        fs = self.fs
        n = SMALL_B

        def replay():
            u_all = fs.random_uniform_rows(SEED, (8 * FULL_T, n), self.dev)
            rb = torch.zeros((16, n), dtype=torch.int32, device=self.dev)
            rscore = torch.zeros(n, dtype=torch.float32, device=self.dev)
            rtotal = torch.zeros(n, dtype=torch.float32, device=self.dev)
            reps = torch.zeros(n, dtype=torch.int32, device=self.dev)
            bad = torch.zeros((), dtype=torch.int64, device=self.dev)
            for t in range(FULL_T):
                new, s, fin, act = fs.fused_step_uniform(rb, u_all[8 * t:8 * t + 8])
                moved, ms, legal = fs.fused_move(rb, act)
                # a live board made a legal move worth its step score and
                # gained one tile of exponent 1 or 2; a dead one had no move
                gain = new - moved
                one_tile = ((gain != 0).sum(0) == 1) & (gain.sum(0) >= 1) & (gain.sum(0) <= 2)
                live_ok = (legal == 1) & (ms.to(torch.float32) == s) & one_tile
                dead_ok = (legal == 0) & (act == 0) & (s == 0)
                bad += (~torch.where(fin == 1, dead_ok, live_ok)).sum()
                rscore = torch.where(fin == 1, 0.0, rscore + s)
                rtotal = rtotal + s
                reps = reps + fin
                rb = new
            return rb, rscore, reps, rtotal, bad

        rb, rscore, reps, rtotal, bad = self.drive("step replay", replay)
        check(bad.item() == 0, f"{bad.item()} replayed steps broke the move check")
        board, score, episodes, total = self.full_out
        err = max_abs_err((rb, rscore, reps, rtotal),
                          (board[:, :n], score[:n], episodes[:n], total[:n]))
        check(err == 0.0, f"step replay differs from the rollout by {err}")
        return (f"{n} boards x {FULL_T} steps: bit-exact against the rollout, "
                f"every move checked; launches {self.path_launches['step replay']}")

    # 8c: times and the plain versions at the main path's shapes
    def main_path_measure(self) -> str:
        fs = self.fs
        zeros = torch.zeros((16, FULL_B), dtype=torch.int32, device=self.dev)
        times = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fs.fused_rollout(zeros, SEED, FULL_T, FULL_BLOCK)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        times.sort()
        med = times[len(times) // 2]
        rate = FULL_B * FULL_T / med
        rec = self.kernels["fused_rollout"]
        rec["ms"] = med * 1e3
        # a reset's extra instructions (one step in ~112) are not counted
        rec["bound_ms"], rec["bound_by"] = bound(
            self.ops("fused_rollout", FULL_B, FULL_T), FULL_B * (64 + 64 + 12))

        t0 = time.perf_counter()
        want = fs.fused_rollout_reference(zeros, SEED, FULL_T)
        torch.cuda.synchronize()
        rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
        rec["max_abs_err"] = max_abs_err(self.full_out, want)
        check(rec["max_abs_err"] == 0.0, f"full-size rollout differs from plain by {rec['max_abs_err']}")
        del want, self.full_out

        shape = (8 * FULL_T, SMALL_B)
        u = fs.random_uniform_rows(SEED, shape, self.dev)
        urec = self.kernels["random_uniform_rows"]
        urec["ms"] = event_ms(lambda: fs.random_uniform_rows(SEED, shape, self.dev), 20)
        t0 = time.perf_counter()
        want = fs.random_uniform_rows_reference(SEED, shape, self.dev)
        torch.cuda.synchronize()
        urec["plain_ms"] = (time.perf_counter() - t0) * 1e3
        urec["max_abs_err"] = max_abs_err([u], [want])
        check(urec["max_abs_err"] == 0.0, f"uniform rows differ from plain by {urec['max_abs_err']}")
        del u, want
        threads = (shape[0] + 3) // 4 * shape[1]
        urec["bound_ms"], urec["bound_by"] = bound(self.ops("random_uniform_rows", threads),
                                                   4 * shape[0] * shape[1])
        return (f"{rate:.6e} steps/s (median of {TIMED_RUNS}, "
                f"spread {FULL_B * FULL_T / times[-1]:.6e}-{FULL_B * FULL_T / times[0]:.6e}) "
                f"on {self.smi}; rollout kernel {rec['ms']:.3f} ms vs plain {rec['plain_ms']:.1f} ms, "
                f"bit-exact; uniform rows {shape} kernel {urec['ms']:.4f} ms vs plain "
                f"{urec['plain_ms']:.1f} ms, bit-exact")

    # 9
    def batched_env(self) -> str:
        from gym2048_tpu_torch.env import batched

        n, steps = SMALL_B, FULL_T
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        state = batched.reset(gen, n, device=self.dev)
        episodes = torch.zeros((), dtype=torch.int64, device=self.dev)
        lengths = torch.zeros((), dtype=torch.int64, device=self.dev)
        reward = torch.zeros((), dtype=torch.float64, device=self.dev)
        for _ in range(steps):
            products = batched.move_products(state)
            noise = torch.rand((n, 4), generator=gen, device=self.dev)
            action = torch.where(products[2], noise, -1.0).argmax(dim=1)
            state, ts = batched.step_with_products(state, action, products, generator=gen)
            episodes += ts.terminated.sum()
            lengths += torch.where(ts.terminated, ts.steps, 0).sum()
            reward += ts.reward.double().sum()
        eps = episodes.item()
        ep_len = lengths.item() / max(eps, 1)
        per_step = reward.item() / (n * steps)
        check(100 < ep_len < 150, f"env episode length {ep_len}")
        check(8.0 < per_step < 10.5, f"env score per step {per_step}")
        return (f"{n} boards x {steps} random-legal steps: {eps} episodes, "
                f"length {ep_len:.2f}, score/step {per_step:.3f}")

    # 11
    def gather_values(self) -> str:
        """The lookup kernel on the flagship table at full width, on a
        uniform index stream and on the stream a depth-2 search reads."""
        from gym2048_tpu_torch.models import ntuple_big

        tg = self.tg
        net = ntuple_big.make_network(AGENT_ARCH, AGENT_N_VALS, AGENT_THRESHOLDS)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        table = torch.randn(net.table_size, generator=gen, device=self.dev).mul_(100.0)
        self.net, self.table = net, table
        streams = {
            "uniform": torch.randint(0, net.table_size, (GATHER_UNIFORM_N,), generator=gen,
                                     device=self.dev, dtype=torch.int32),
            "real": net.indices_batch(leaf_afterstates(self.leaf_roots)).reshape(-1),
        }
        check(streams["real"].numel() == LEAF_BOARDS * 512 * net.n_features,
              f"real stream of {streams['real'].numel()} indices")
        parts = []
        for label, idx in streams.items():
            got = tg.gather_values(table, idx)
            want = tg.gather_values_reference(table, idx)
            err = max_abs_err([got], [want])
            check(err == 0.0 and torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"gather_values differs from plain on the {label} stream by {err}")
            idx64 = idx.long()
            n = idx.numel()
            ms = graph_ms(lambda: tg.gather_values(table, idx), 20)
            lib_ms = graph_ms(lambda: torch.take(table, idx64), 20)
            plain_ms = event_ms(lambda: tg.gather_values_reference(table, idx), 5)
            sectors = torch.unique(idx // 8).numel()
            b_ms, b_by = bound(self.ops("gather_values", n // 4), 8 * n + 32 * sectors)
            parts.append(f"{label} N={n}: bit-exact, kernel {ms:.4f} ms, torch.take "
                         f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms, {sectors} distinct "
                         f"32-B sectors ({sectors / n:.4f} per index), bound "
                         f"{b_ms:.4f} ms ({b_by})")
            if label == "real":
                rec = self.kernels["gather_values"]
                rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
            del got, want, idx64
        del streams
        return (f"table {AGENT_ARCH} n_vals {AGENT_N_VALS} thresholds {AGENT_THRESHOLDS}: "
                f"{net.table_size} f32; " + "; ".join(parts))

    # 12
    def agent_path(self) -> str:
        """The flagship agent over the full-width table, driven as path
        "agent"; its first moves are replayed with the plain lookup."""
        from gym2048_tpu_torch.agents import expectimax as ex

        net, table = self.net, self.table
        rec = MoveRecord(ex.make_adaptive_policy(net.value_batch, AGENT_K_DEEP, AGENT_EMPTY_MAX))
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        t0 = time.perf_counter()
        res = self.drive("agent", lambda: ex.play_policy(
            rec, AGENT_GAMES, gen, AGENT_MOVE_CAP, AGENT_CHUNK, params=table,
            needs_active=True, device=self.dev))
        secs = time.perf_counter() - t0
        moves = len(rec.actions)
        searched = sum(e["moves"] for e in res["Episodes"])
        illegal, _, lengths = rec.replay(moves)
        check(illegal == 0, f"{illegal} illegal actions on live boards")
        check(lengths == [e["moves"] for e in res["Episodes"]], "play_policy and the record disagree")

        plain = MoveRecord(ex.make_adaptive_policy(plain_value_fn(net), AGENT_K_DEEP,
                                                   AGENT_EMPTY_MAX))
        launched = self.tg.LAUNCHES["gather_values"]
        pres = ex.play_policy(plain, AGENT_GAMES, torch.Generator(device=self.dev).manual_seed(SEED),
                              REPLAY_MOVES, AGENT_CHUNK, params=table, needs_active=True,
                              device=self.dev)
        check(self.tg.LAUNCHES["gather_values"] == launched, "the plain replay launched the kernel")
        check(len(plain.actions) == REPLAY_MOVES and moves >= REPLAY_MOVES, "replay length")
        check(torch.equal(torch.stack(rec.actions[:REPLAY_MOVES]), torch.stack(plain.actions)),
              f"actions differ from the plain lookup's within {REPLAY_MOVES} moves")
        mine, theirs = rec.replay(REPLAY_MOVES), plain.replay(REPLAY_MOVES)
        check(mine == theirs, "scores or lengths differ from the plain replay")
        check([e["total_reward"] for e in pres["Episodes"]] == theirs[1]
              and [e["moves"] for e in pres["Episodes"]] == theirs[2],
              "the plain replay's result disagrees with its record")
        launches = self.path_launches["agent"]["gather_values"]
        live = sum(1 for e in res["Episodes"] if e["moves"] == moves)
        return (f"adaptive depth 3 (k_deep {AGENT_K_DEEP}, empties <= {AGENT_EMPTY_MAX}, beam) "
                f"over the {net.table_size}-entry table, {AGENT_GAMES} games, {moves} lockstep "
                f"moves (cap {AGENT_MOVE_CAP}), {live} games live at the cap: "
                f"{searched / secs:.1f} searched moves/s ({searched} in {secs:.2f} s) on "
                f"{self.smi}; mean score {res['Average score']:.1f}, mean length "
                f"{searched / AGENT_GAMES:.1f}, highest tile {res['Highest tile']}; every live "
                f"action legal; first {REPLAY_MOVES} moves identical to the plain lookup's "
                f"(actions, scores, lengths); gather_values {launches} launches, "
                f"{launches / moves:.2f} per move")

    # 12b
    def agent_profile(self) -> str:
        """``torch.profiler`` over a few lockstep moves of the flagship agent
        on fresh games (phase 12 warmed it up): the device's busy share of
        the wall time and the kernels that take the most device time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from gym2048_tpu_torch.agents import expectimax as ex

        pol = ex.make_adaptive_policy(self.net.value_batch, AGENT_K_DEEP, AGENT_EMPTY_MAX)
        moves = 4
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.play_policy(pol, AGENT_GAMES, torch.Generator(device=self.dev).manual_seed(SEED),
                           moves, moves, params=self.table, needs_active=True, device=self.dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels, copies, sets): host operators
        # also carry the device time of what they launched
        device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        busy = sum(device_us.values())
        if busy == 0:
            return "torch.profiler recorded no device time: busy share not measured"
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:3]
        gather = sum(us for k, us in device_us.items() if "gather" in k and "_kernel" in k)
        return (f"{moves} moves x {AGENT_GAMES} games under the profiler: wall "
                f"{wall_us / moves / 1e3:.3f} ms per move, device busy {busy / moves / 1e3:.3f} "
                f"ms per move ({busy / wall_us:.4f} of the wall time), {len(device_us)} "
                f"distinct device kernels, the gather kernels {gather / busy:.4f} of the "
                f"device time; top: " + "; ".join(f"{k[:50]} {us / busy:.3f}" for k, us in top))

    # 13
    def agent_timing(self) -> str:
        """Depth-2 afterstate search, 512 games (the README's CLI config),
        one chunk of moves per run; searched moves/s, median of 3."""
        from gym2048_tpu_torch.agents import expectimax as ex

        pol = ex.make_afterstate_policy(self.net.value_batch, depth=2, parametrised=True)
        rates = []
        for _ in range(3):
            gen = torch.Generator(device=self.dev).manual_seed(SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ex.play_policy(pol, TIMING_GAMES, gen, AGENT_CHUNK, AGENT_CHUNK,
                                 params=self.table, device=self.dev)
            rates.append(sum(e["moves"] for e in res["Episodes"]) / (time.perf_counter() - t0))
        rates.sort()
        return (f"{TIMING_GAMES} games x {AGENT_CHUNK} moves at depth 2: {rates[1]:.1f} "
                f"searched moves/s (median of 3, spread {rates[0]:.1f}-{rates[2]:.1f}) "
                f"on {self.smi}; mean score {res['Average score']:.1f}")

    # 14
    def heuristic_expectimax(self) -> str:
        """The heuristic-leaf search (no kernel) on the card."""
        from gym2048_tpu_torch.agents import expectimax as ex

        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        t0 = time.perf_counter()
        res = ex.play_batched(AGENT_GAMES, depth=2, generator=gen, move_cap=AGENT_CHUNK,
                              device=self.dev)
        secs = time.perf_counter() - t0
        moves = [e["moves"] for e in res["Episodes"]]
        check(min(moves) >= 1 and res["Average score"] > 0, f"heuristic games {res}")
        return (f"play_batched depth 2, {AGENT_GAMES} games, cap {AGENT_CHUNK}: "
                f"{sum(moves) / secs:.1f} searched moves/s, mean score "
                f"{res['Average score']:.1f}, mean length {sum(moves) / len(moves):.1f}")

    # 15a
    def td_path(self) -> str:
        """The flagship TD learner at full width, one chunk, driven as path
        "td": one lookup kernel launch per step."""
        from gym2048_tpu_torch.train import td

        cfg = td.TDConfig(**TD_FLAGSHIP)
        self.td_trainer = tr = td.TDTrainer(cfg, device=self.dev)
        state = tr.init_state()
        t0 = time.perf_counter()
        state, m = self.drive("td", lambda: tr.train_chunk(state, 1.0))
        secs = time.perf_counter() - t0
        launches = self.path_launches["td"]["gather_values"]
        check(launches == cfg.chunk_steps, f"{launches} lookups in a {cfg.chunk_steps}-step chunk")
        check(all(torch.isfinite(state[k]).all().item() for k in ("table", "tc_e", "tc_a")),
              "non-finite table or accumulators")
        check(not {"tc_ps", "tc_pa", "tc_pc"} & set(state), "pending buffers left in the state")
        filled = state["car_filled"].sum(1).tolist()
        self.td_state = state
        return (f"{cfg.arch} n_vals {cfg.n_vals} thresholds {cfg.thresholds}, "
                f"{tr._net.table_size} f32 x 3 (table, tc_e, tc_a), {cfg.n_envs} envs, "
                f"tc_every {cfg.tc_every}, carousel {cfg.carousel}: first chunk of "
                f"{cfg.chunk_steps} steps in {secs:.3f} s (allocation included), "
                f"{m['episodes'].item():.0f} episodes, highest exponent "
                f"{m['highest_exp'].item()}, reservoir slots filled per stage {filled}; "
                f"launches {self.path_launches['td']}")

    # 15b
    def td_gather(self) -> str:
        """The lookup kernel on the TD step's own stream: the 4 afterstates
        of each of the 8192 boards of the learner's state."""
        from gym2048_tpu_torch.core import rules

        tg, net, table = self.tg, self.td_trainer._net, self.td_state["table"]
        boards = self.td_state["boards"]
        moved = rules.move_all(boards)[0].reshape(-1, 4, 4)
        idx = net.indices_batch(moved).reshape(-1)
        n = idx.numel()
        check(n == 4 * boards.shape[0] * net.n_features, f"TD stream of {n} indices")
        got = tg.gather_values(table, idx)
        want = tg.gather_values_reference(table, idx)
        err = max_abs_err([got], [want])
        check(err == 0.0 and torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"gather_values differs from plain on the TD stream by {err}")
        idx64 = idx.long()
        rec = self.kernels["gather_values"]
        ms = graph_ms(lambda: tg.gather_values(table, idx), 20)
        lib_ms = graph_ms(lambda: torch.take(table, idx64), 20)
        plain_ms = event_ms(lambda: tg.gather_values_reference(table, idx), 5)
        sectors = torch.unique(idx // 8).numel()
        b_ms, b_by = bound(self.ops("gather_values", n // 4), 8 * n + 32 * sectors)
        rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        return (f"N={n} (4 afterstates x {boards.shape[0]} boards x {net.n_features}): "
                f"bit-exact, kernel {ms:.4f} ms, torch.take {lib_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, {sectors} distinct 32-B sectors ({sectors / n:.4f} per "
                f"index), bound {b_ms:.4f} ms ({b_by}); "
                f"{self.path_launches['td']['gather_values']} launches per chunk")

    # 15c
    def td_replay(self) -> str:
        """A full-width flagship chunk of 16 steps from the learner's state,
        with the lookup kernel and with the plain lookup, in deterministic
        mode: every leaf of the state must be equal bit for bit, and equal
        again when the kernel's chunk is repeated. The same chunk twice in
        the default mode gives the mode's cost and shows whether the
        default mode repeats itself."""
        import dataclasses

        from gym2048_tpu_torch.train import td

        cfg = dataclasses.replace(self.td_trainer.cfg, chunk_steps=TD_REPLAY_STEPS)
        tr = td.TDTrainer(cfg, device=self.dev)

        def run(lookup: str, deterministic: bool):
            launched = self.tg.LAUNCHES["gather_values"]
            torch.use_deterministic_algorithms(deterministic)
            try:
                with plain_lookup() if lookup == "plain" else contextlib.nullcontext():
                    state, secs, _ = timed_chunks(tr, clone_state(self.td_state), 1)
            finally:
                torch.use_deterministic_algorithms(False)
            kernel_launches = self.tg.LAUNCHES["gather_values"] - launched
            check(kernel_launches == (TD_REPLAY_STEPS if lookup == "kernel" else 0),
                  f"{kernel_launches} kernel launches in the {lookup} run")
            return state, secs[0]

        det1, det1_s = run("kernel", True)
        plain, plain_s = run("plain", True)
        default1, default1_s = run("kernel", False)
        det2, det2_s = run("kernel", True)
        default2, default2_s = run("kernel", False)
        bad = state_diffs(det1, plain)
        check(not bad, f"the plain-lookup chunk differs from the kernel's in {bad}")
        bad = state_diffs(det1, det2)
        check(not bad, f"two deterministic chunks differ in {bad}")
        moved = (det1["table"] != self.td_state["table"]).sum().item()
        check(moved > 0, "the replayed chunk did not move the table")
        return (f"{TD_REPLAY_STEPS} steps x {cfg.n_envs} envs, deterministic mode: kernel "
                f"and plain lookup give identical states in all {len(det1)} leaves "
                f"({moved} table entries moved), and so does the kernel's chunk repeated; "
                f"seconds per chunk: deterministic {det1_s:.3f} then {det2_s:.3f} with the "
                f"kernel, {plain_s:.3f} plain; default mode {default1_s:.3f} and "
                f"{default2_s:.3f}; leaves that differ between the two default-mode chunks: "
                f"{state_diffs(default1, default2)}, between default and deterministic: "
                f"{state_diffs(default1, det1)}")

    def td_rate(self, config: dict, label: str) -> str:
        from gym2048_tpu_torch.train import td

        tr = td.TDTrainer(td.TDConfig(**config), device=self.dev)
        state, _, _ = timed_chunks(tr, tr.init_state(), 1)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launched = self.tg.LAUNCHES["gather_values"]
        state, secs, m = timed_chunks(tr, state, TD_TIMED_CHUNKS)
        per_chunk = (self.tg.LAUNCHES["gather_values"] - launched) / TD_TIMED_CHUNKS
        peak = torch.cuda.max_memory_allocated()
        steps = tr.cfg.n_envs * tr.cfg.chunk_steps
        rates = sorted(steps / x for x in secs)
        del state
        return (f"{label}: {rates[len(rates) // 2]:.1f} steps/s (median of {TD_TIMED_CHUNKS} "
                f"chunks of {tr.cfg.chunk_steps} steps, spread {rates[0]:.1f}-{rates[-1]:.1f}), "
                f"peak {peak / 2**30:.3f} GiB allocated ({(peak - base) / 2**30:.3f} GiB above "
                f"the {base / 2**30:.3f} GiB held before), {per_chunk:.0f} gather launches per "
                f"chunk, ep_score_mean {m['ep_score_mean'].item():.1f}")

    # 15d
    def td_throughput(self) -> str:
        """Steps/s of the learner in the CLI's default mode at full width:
        the flagship config and bench.py's bench_td_big cell."""
        return (self.td_rate(TD_FLAGSHIP, "flagship (ntuple_4x6_tc_r5 config)") + "; "
                + self.td_rate(TD_BENCH_BIG, "bench_td_big (4x6 TC unstaged, 16 steps)")
                + f"; on {self.smi}")

    # 15e
    def td_profile(self) -> str:
        """``torch.profiler`` over one flagship chunk (device events only):
        the device's busy share and top kernels; and the device time of the
        chunk's table-sized pieces, each timed alone at full width."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from gym2048_tpu_torch.models.ntuple import _tc_combine

        tr, state = self.td_trainer, clone_state(self.td_state)
        steps = tr.cfg.chunk_steps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_chunk(state, 1.0)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        busy = sum(device_us.values())
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
        profiled = (f"wall {wall_us / steps / 1e3:.3f} ms per step under the profiler, device "
                    f"busy {busy / steps / 1e3:.3f} ms per step ({busy / wall_us:.4f} of the "
                    f"wall time), {launches / steps:.1f} device kernels per step, "
                    f"{len(device_us)} distinct; top: "
                    + "; ".join(f"{short_kernel_name(k)} {us / busy:.3f}" for k, us in top)
                    if busy else "torch.profiler recorded no device time: busy share not "
                    "measured")
        # the pieces, timed alone on the state's arrays
        net, table = tr._net, state["table"]
        pend = tuple(torch.zeros_like(table) for _ in range(3))
        boards = state["prev_after"]
        delta = torch.randn(boards.shape[0], generator=torch.Generator(device=self.dev)
                            .manual_seed(SEED), device=self.dev)
        alpha = torch.tensor(1.0)
        acc_ms = graph_ms(lambda: net.tc_accumulate(pend, boards, delta,
                                                    valid=state["prev_valid"]), 10)
        comb_ms = event_ms(lambda: _tc_combine(table, state["tc_e"], state["tc_a"], *pend,
                                               alpha), 3)
        zero_ms = event_ms(lambda: [p.zero_() for p in pend], 3)
        torch.cuda.synchronize()
        del pend
        k = tr.cfg.tc_every
        step_ms = busy / steps / 1e3 if busy else float("nan")
        tc_bytes = 9 * table.numel() * 4  # read table, tc_e, tc_a, 3 pending; write 3
        return (profiled + f". Alone: tc_accumulate ({boards.shape[0]} boards) {acc_ms:.4f} ms, "
                f"_tc_combine {comb_ms:.3f} ms ({tc_bytes / comb_ms / 1e9:.3f} TB/s of its "
                f"{tc_bytes / 2**30:.2f} GiB of inputs and outputs), zeroing the pending "
                f"buffers {zero_ms:.3f} ms; per step: scatter {acc_ms / step_ms:.3f}, combine "
                f"{comb_ms / k / step_ms:.3f}, zeroing {zero_ms / k / step_ms:.3f} of the "
                f"device time")

    # 15f
    def td_learning(self) -> str:
        """50 chunks of the unstaged 4x6 TC learner from an empty table: the
        last chunk's episode score must lie in the band of the JAX runs."""
        from gym2048_tpu_torch.train import td

        cfg = td.TDConfig(**TD_LEARN)
        tr = td.TDTrainer(cfg, device=self.dev)
        t0 = time.perf_counter()
        state, hist = tr.learn(log_every=10, log_fn=None)
        secs = time.perf_counter() - t0
        last = hist[-1]
        check(last.steps == cfg.total_steps, f"trained {last.steps} steps")
        check(torch.isfinite(state["table"]).all().item(), "non-finite table")
        lo, hi = TD_LEARN_BAND
        check(lo <= last.ep_score_mean <= hi,
              f"ep_score_mean {last.ep_score_mean} at {last.steps} steps outside [{lo}, {hi}]")
        curve = ", ".join(f"{e.steps}: {e.ep_score_mean:.1f} ({e.episodes:.0f} episodes)"
                          for e in hist)
        return (f"{cfg.arch} TC unstaged, {cfg.n_envs} envs, {cfg.total_steps} steps in "
                f"{secs:.2f} s ({cfg.total_steps / secs:.1f} steps/s): ep_score_mean {curve}; "
                f"the last in [{lo:.0f}, {hi:.0f}], highest tile {last.highest_tile_max}")

    # 16
    def launch_counters(self) -> str:
        self.zero_launches()
        for name in KERNELS:
            check(self.run_launches[name] > 0, f"{name} never launched")
        return (f"per path {self.path_launches}; in the whole run {self.run_launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smoke = Smoke()
    smoke.run("1", "device", smoke.device)
    smoke.run("2", "build", smoke.build)
    smoke.run("3", "philox", smoke.philox)
    smoke.run("4", "fused_move", smoke.fused_move)
    smoke.run("5", "fused_step_uniform", smoke.fused_step_uniform)
    smoke.run("6", "fused_rollout", smoke.fused_rollout_small)
    smoke.run("7", "random_uniform_rows", smoke.random_uniform_rows_small)
    smoke.run("8a", "main path", smoke.main_path)
    smoke.run("8b", "step replay", smoke.step_replay)
    smoke.run("8c", "main path timing", smoke.main_path_measure)
    smoke.run("9", "batched env", smoke.batched_env)
    smoke.run("11", "gather_values", smoke.gather_values)
    smoke.run("12", "agent path", smoke.agent_path)
    smoke.run("12b", "agent profile", smoke.agent_profile)
    smoke.run("13", "agent timing", smoke.agent_timing)
    smoke.run("14", "heuristic expectimax", smoke.heuristic_expectimax)
    smoke.run("15a", "td path", smoke.td_path)
    smoke.run("15b", "td gather", smoke.td_gather)
    smoke.run("15c", "td kernel vs plain", smoke.td_replay)
    smoke.run("15d", "td throughput", smoke.td_throughput)
    smoke.run("15e", "td profile", smoke.td_profile)
    smoke.run("15f", "td learning", smoke.td_learning)
    smoke.run("16", "launch counters", smoke.launch_counters)
    print(f"total {time.perf_counter() - t_start:.2f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smoke.smi)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in smoke.kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
