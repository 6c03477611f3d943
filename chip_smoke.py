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
  an episode score inside the band that the JAX runs bracket;
* the small 17 x 4-cell TD learner (the learner's default ``--arch
  small``): the config of ``docs/curves/ntuple_table_tc1b.pkl`` at full
  width (8192 envs, TC, the 1,419,857-entry table), one 64-step chunk, one
  lookup kernel launch per step. The lookup is timed on its stream, the
  first path stream whose table fits in the L2; 16-step chunks with the
  exact and the split lookup are replayed with the plain lookup in
  deterministic mode and must leave every leaf identical; three configs
  are timed and one profiled; the config of ``docs/curves/td_mxu_run.jsonl``
  must learn into the band that the JAX runs bracket, and its table is
  played greedily and by the expectimax CLI's small-table policy at depth
  2, whose first 128 moves are replayed with the plain lookup.

Then the ``ops`` transforms (observation encoders, augmentation, returns)
on the card must equal their CPU results, and the CNN path (phases 19a-19e:
the forward, PPO, BC, the evaluators) runs on the card.

Last, the shell (phase 20, path "shell", none of our kernels): the native
engine built with ``g++`` and held against ``rules_np`` and ``core.rules``;
then the reference's user flow through the port's CLIs in ``build/shell/``:
``selfplay`` (every row checked, the CSV byte-identical from the native and
numpy writers) -> ``pretrain_bc`` (ActorCritic(64, 4), the flax-layout
pickle) -> ``selfplay --policy model`` -> ``ppo --pretrained`` at the
production shape with checkpoints, the restored state equal leaf for leaf,
and ``--resume`` -> ``evaluate`` (the reference protocol on the card and on
the CPU, and ``--fast``) -> ``train`` (Game2048Model(64, 8)).

Before the paths, the single-step kernels, and the rollout for 32 steps,
are held bit for bit against their plain versions on 65,536 boards of
eight families (random, exponents 15-17, dead, full with merges only, one
legal direction, boards where only the spawn can win, early game); the
single-step kernels are timed at four sizes, from 1,024 boards to
1,048,576, past the L2; the registers of the built library
(``cuobjdump -res-usage``) give blocks per SM and waves. The lookup
kernel is timed on a uniform stream at four sizes, from 1,024 indices to
67,108,864, and on the agent's, the TD step's and a trained learner's
stream, each warm (a graph replay) and cold (after a 128 MB write).

Each phase prints one line with its seconds; any failed check raises, so
the exit code is non-zero. Without CUDA it exits non-zero before printing
any result: it never runs on the CPU.

The last lines of standard output are the card's name and power limit as
``nvidia-smi`` reports them, one JSON object with each kernel's launches,
error, times and bound, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
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
# An sm_90 SM holds 65,536 registers, given out to warps in units of 256,
# at most 64 warps and 32 blocks (the CUDA occupancy rules); the step
# kernels use no shared memory.
SM_REGISTERS, REG_UNIT, SM_WARPS, SM_BLOCKS = 65536, 256, 64, 32
# Fixed yardsticks for the rollout, which its own bound (counted from the
# SASS of the code that runs) cannot be: the issue bound of the first
# rollout kernel, whose step computed all four moves (1,400 SASS
# instructions a step; NVIDIA H100 80GB HBM3, 700 W), and that bound scaled
# by 672 / 1,536, the SASS of a whole fused_step_uniform launch on the one-
# move step against the four-move one's.
ROLLOUT_BOUND_4MOVE_MS = 44.939
ROLLOUT_BOUND_1MOVE_EST_MS = 44.939 * 672 / 1536

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
# Threads per block of the fused library's kernels, as their launchers in
# fused_step.cu set them (kStepThreads, kRolloutThreads, kThreads).
BLOCK_THREADS = {"fused_move": 128, "fused_step_uniform": 128, "fused_rollout": 128,
                 "random_uniform_rows": 256}
# The paths that drive the kernels, each read with its own launch counts:
# the engine's rollout, the step-by-step replay that runs the single-step
# kernels on the rollout's own uniforms, and the n-tuple agent.
PATHS = {
    "rollout": ("fused_rollout",),
    "step replay": ("fused_step_uniform", "fused_move", "random_uniform_rows"),
    "agent": ("gather_values",),
    "td": ("gather_values",),
    "td small": ("gather_values",),
    "ppo": (),  # the CNN, PPO's env and the optimiser: plain PyTorch, no kernel of ours
    "shell": (),  # the CLIs (phase 20): the same device code as "ppo", and the host
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
# The uniform stream's sizes: every index in flight at once (the launch);
# 1,048,576, whose indices, output and table sectors (40 MB) stay in the
# 50 MB L2 across a graph replay; the agent stream's N and one 8 times
# larger, which come from HBM.
GATHER_SIZES = (1 << 10, 1 << 20, GATHER_UNIFORM_N, 1 << 26)
# Written before each launch of a cold lookup: 2.5 times the L2.
FLUSH_BYTES = 128 << 20
# Clock cycles of the spin kernel before each call that alone_ms times
# (~50 us at 1.98 GHz, longer than the host takes to queue one call).
SPIN_CYCLES = 100_000
# Threads per block of the gather kernels (kThreads in table_gather.cu; a
# test holds gather_launches to the kernel's own launch plan).
GATHER_THREADS = 256
# Rounds of the same-call comparison of gather sources (--gather-ab).
GATHER_AB_ROUNDS = 12
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

# The small net (the learner's default arch): docs/curves/ntuple_table_tc1b.pkl's
# config (total_steps excepted), on the default lookup ("auto", the exact one).
TD_SMALL = dict(n_envs=8192, chunk_steps=64, alpha=1.0, alpha_final=1.0, init_value=80_000.0,
                seed=0, update_impl="mxu", value_impl="auto", tc=True)
# bench.py::bench_td: 8192 envs x 64 steps, the split lookup, alpha 0.1, no TC
TD_BENCH_SMALL = dict(n_envs=8192, chunk_steps=64, update_impl="mxu", value_impl="mxu",
                      alpha=0.1, alpha_final=0.1)
# docs/curves/td_mxu_run.jsonl: 8192 envs x 64, alpha 0.25 -> 0.05 over 150M
# steps, init 80,000, no TC, the split lookup; its second line is at
# 41,943,040 steps = 80 chunks
TD_SMALL_LEARN = dict(n_envs=8192, chunk_steps=64, alpha=0.25, alpha_final=0.05,
                      init_value=80_000.0, seed=7, total_steps=150_000_000,
                      update_impl="mxu", value_impl="mxu")
TD_SMALL_LEARN_CHUNKS = 80
# The JAX runs logged 37,584.1 (td_mxu_run.jsonl) and 39,778.5 (td_run.jsonl)
# at that step; random play scores ~1,000.
TD_SMALL_LEARN_BAND = (24_000.0, 56_000.0)
GREEDY_GAMES = 256
GREEDY_MIN = 10_000.0      # JAX's greedy play at 150M steps: 46,949 (td_eval.json)
SMALL_AGENT_GAMES, SMALL_AGENT_MOVE_CAP = 64, 512

# The CNN path (phases 19a-19e): ActorCritic(64, 4), the model the repo trains
# and ships (the meta of docs/curves/ppo_{long,masked,tpu}_model.pkl).
CNN_FILTERS, CNN_BLOCKS = 64, 4
FORWARD_BATCHES = (256, 4096, 16384)  # entry(); a rollout step; an update minibatch
FORWARD_CHECK_BATCHES = (256, 4096)   # held against the CPU with TF32 off
# bench.py::bench_ppo: the production shape (4096 envs x 128 steps, batch
# 16,384, 4 epochs, the sharded shuffle; bf16, and the same in f32) and the
# reference's SB3 defaults (8 envs x 2048 steps, batch 256, 4 epochs, f32)
PPO_PRODUCTION = dict(total_timesteps=10**9, n_envs=4096, n_steps=128, batch_size=16384,
                      shuffle_mode="sharded")
PPO_REFERENCE = dict(total_timesteps=10**9)
PPO_TIMED_ITERATIONS = 3
# The profiled iteration's n_steps (production, reference): its rollout steps
# and SGD steps both scale with n_steps, so kernels an iteration scale too
PPO_PROFILE_STEPS = (8, 32)
# docs/curves/ppo_tpu_config.jsonl: the CLI at the commit that logged it (f32:
# it had no --bf16; the global shuffle: it passed no shuffle_mode) with
# --n-envs 4096 --n-steps 128 --batch-size 16384 --log2-rewards (its
# value_loss, 90.3 at row 1, is the log2 scale's), seed 42 (the CLI's); 524,288
# steps a row. It logged ep_return_mean 51.7 and 58.3 at rows 1-2, 260.3 and
# 277.2 at rows 11-12.
PPO_LEARN = dict(total_timesteps=10**9, n_envs=4096, n_steps=128, batch_size=16384,
                 log2_rewards=True)
PPO_LEARN_ITERATIONS = 12
PPO_FIRST_BAND = (35.0, 75.0)  # the untrained policy's ep_return_mean
PPO_LAST_MIN, PPO_GAIN_MIN = 150.0, 2.0
# BC: build_bc_trainer_for_ppo() for one epoch over boards labelled by the
# rule of tests/test_train.py::synthetic_dataset (exponents 0-7, argmax % 4)
BC_SAMPLES, BC_ACCURACY_MIN = 262_144, 0.6
EVAL_EPISODES, LEAF_BOARDS_CNN = 512, 64
# The shell path (phases 20a-20g): the reference's user flow through the port's
# CLIs, selfplay -> CSV -> pretrain_bc -> ppo --pretrained with checkpoints and
# --resume -> evaluate, and train, run in SHELL_DIR (the CLIs write into the
# working directory). ActorCritic(64, 4) (pretrain_bc's and ppo's defaults) and
# Game2048Model(64, 8) (train's).
SHELL_DIR = "build/shell"
ENGINE_BOARDS = 1 << 20
RULES_NP_SAMPLE = 4096     # boards also run one at a time through rules_np.move
SELFPLAY_N, SELFPLAY_BATCH = 65_536, 4096
STATS_BATCH = 256          # random play long enough to finish games: 256 steps an env
SHELL_PPO = ["--n-envs", "4096", "--n-steps", "128", "--batch-size", "16384", "--bf16",
             "--mask-illegal", "--save-interval", "1", "--video-freq", "0",
             "--log-interval", "1", "--run-name", "shell", "--seed", str(SEED)]
SHELL_PPO_ROLLOUT = 4096 * 128
HOST_EVAL_EPISODES, HOST_EVAL_EPSILON, FAST_EVAL_EPISODES = 10, 0.1, 512
FLIP_MARGIN_MAX = 1e-4     # a card/CPU argmax flip must be roundoff: a top-2 gap below this
# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

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


def captured(fn, reps: int):
    """``reps`` calls of ``fn`` captured in one CUDA graph, replayed once."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, reps: int) -> float:
    """One replay of ``graph`` between two events, in ms over ``reps``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, samples: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in one
    CUDA graph, the graph replayed ``samples`` times between two events
    each, and the median replay over ``reps``. The graph leaves out the
    host's cost of each call (checks, allocation, the ctypes call). From
    the second call on, whatever of its data fits stays in the L2."""
    graph = captured(fn, reps)
    return sorted(replay_ms(graph, reps) for _ in range(samples))[samples // 2]


def cold_graph_ms(fn, flush, reps: int, samples: int = 5) -> float:
    """Device time of one call of ``fn`` in ms after ``flush`` has pushed its
    data out of the L2: the median replay of ``reps`` pairs (flush, fn) in
    one graph, minus that of ``reps`` flushes alone in another, the two
    replayed in turns."""
    both = captured(lambda: (flush(), fn()), reps)
    alone = captured(flush, reps)
    pairs = [(replay_ms(both, reps), replay_ms(alone, reps)) for _ in range(samples)]
    return (sorted(p[0] for p in pairs)[samples // 2]
            - sorted(p[1] for p in pairs)[samples // 2])


def median_of(measure, times: int = 3) -> float:
    """The median of ``times`` calls of ``measure``."""
    return sorted(measure() for _ in range(times))[times // 2]


def gather_launches(n: int, idx_ptr: int = 0, out_ptr: int = 0) -> list[tuple[bool, int, int]]:
    """The launches ``gym_gather_values`` makes for ``n`` indices at these
    addresses, each (16-byte kernel or not, indices, blocks of
    ``GATHER_THREADS``): where both pointers lie at one offset modulo 16
    bytes, the groups of four from the first 16-byte boundary on, then a
    scalar head and a scalar tail of up to three indices each where there
    are any; else one index per thread over all ``n``."""
    def blocks(work: int) -> int:
        return -(-work // GATHER_THREADS)

    if idx_ptr % 16 != out_ptr % 16:
        return [(False, n, blocks(n))]
    head = min(n, (16 - idx_ptr % 16) % 16 // 4)
    n4 = (n - head) // 4
    tail = n - head - 4 * n4
    return ([(True, 4 * n4, blocks(n4))] if n4 else []) + [
        (False, m, 1) for m in (head, tail) if m]


def alone_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms, launched on its own as an
    eager caller launches it: each call queued behind a spin kernel (which
    hides the host's time to queue it) between two events of its own; the
    median over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in events)[reps // 2]


def bound_terms(ops: float, nbytes: float) -> tuple[float, float]:
    """The issue time of ``ops`` thread instructions and the memory time of
    ``nbytes``, in ms."""
    return ops / ISSUE_PER_S * 1e3, nbytes / MEM_BYTES_PER_S * 1e3


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for ``ops`` thread instructions and ``nbytes`` of
    memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = bound_terms(ops, nbytes)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def resource_usage(text: str) -> dict[str, dict[str, int]]:
    """Kernel -> its fields (``REG``, ``STACK``, ``LOCAL``, ...) in the
    ``cuobjdump -res-usage`` listing of a built library: the registers and
    stack frame ptxas gave each kernel that is launched."""
    from gym2048_tpu_torch._sass import short_name

    usage, current = {}, None
    for line in text.splitlines():
        if m := re.match(r"\s*Function (\S+?):?\s*$", line):
            current = short_name(m.group(1))
        elif current and (fields := re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", line)):
            usage[current], current = {k: int(v) for k, v in fields}, None
    return usage


def blocks_per_sm(registers: int, threads: int) -> int:
    """Blocks of ``threads`` threads that one SM holds at ``registers``
    registers a thread."""
    warps = math.ceil(threads / 32)
    per_warp = math.ceil(registers * 32 / REG_UNIT) * REG_UNIT
    return min(SM_REGISTERS // per_warp // warps, SM_WARPS // warps, SM_BLOCKS)


def random_boards(rng, n: int, max_exp: int, p_zero: float) -> np.ndarray:
    exps = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def dead_boards(rng, n: int) -> np.ndarray:
    """Full boards with no move: cell (r, c) holds exponent number
    (r + 2c) % 4 of four distinct exponents from 1-17, so no two
    neighbours are equal."""
    palette = rng.random((n, 17)).argsort(axis=1)[:, :4] + 1
    r, c = np.indices((4, 4))
    return palette[:, (r + 2 * c) % 4].astype(np.int8)


BOARD_FAMILIES = ("random 0-17", "random 0-12", "exponents 15-17", "dead",
                  "full, merge only", "one legal direction", "no 1 or 2",
                  "early game")


def adversarial_boards(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` boards of the families of ``BOARD_FAMILIES``, in eight equal
    runs, and each board's family: random boards of exponents 0-17 and
    0-12; tiles of exponents 15-17 only (merges to 17 and 18); dead boards;
    full boards whose only moves are merges (a dead board with one cell
    copied into a neighbour); boards with exactly one legal direction (a
    dead board with its first 1-3 rows emptied, turned a random number of
    quarter turns); boards with no tile of exponent 1 or 2, where a win at
    ``max_tile_exp`` 1 or 2 can come only from the spawn; and early-game
    boards."""
    k = n // 8
    sizes = [n - 7 * k] + [k] * 7
    fam = []
    fam.append(random_boards(rng, sizes[0], 17, 0.35))
    fam.append(random_boards(rng, k, 12, 0.4))
    fam.append(np.where(rng.random((k, 4, 4)) < 0.3, 0,
                        rng.integers(15, 18, size=(k, 4, 4))).astype(np.int8))
    fam.append(dead_boards(rng, k))
    full = dead_boards(rng, k)
    rows, cols = rng.integers(0, 4, k), rng.integers(0, 3, k)
    across = rng.random(k) < 0.5  # copy into the right neighbour, else the one below
    src = full[np.arange(k), np.where(across, rows, cols), np.where(across, cols, rows)]
    full[np.arange(k), np.where(across, rows, cols + 1), np.where(across, cols + 1, rows)] = src
    fam.append(full)
    one = dead_boards(rng, k)
    one[np.arange(4)[None, :] < rng.integers(1, 4, k)[:, None]] = 0
    turns = rng.integers(0, 4, k)
    fam.append(np.stack([np.rot90(b, t) for b, t in zip(one, turns)]).astype(np.int8))
    no12 = rng.integers(3, 18, size=(k, 4, 4))
    fam.append(np.where(rng.random((k, 4, 4)) < 0.5, 0, no12).astype(np.int8))
    fam.append(random_boards(rng, k, 6, 0.6))
    return np.concatenate(fam), np.repeat(np.arange(8), sizes)


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


def checkpoint_diffs(a, b) -> list[str]:
    """The leaves of two training states, as the Checkpointer saves them
    (a state, or a host tree it restored), that are not equal bit for bit."""
    from gym2048_tpu_torch.utils.checkpoint import _state_to_host

    bad = []

    def walk(x, y, where):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.reshape(-1).contiguous().view(torch.uint8),
                                    y.reshape(-1).contiguous().view(torch.uint8))):
                bad.append(where)
        elif isinstance(x, dict):
            if not isinstance(y, dict) or set(x) != set(y):
                bad.append(where)
            else:
                for k in x:
                    walk(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, (list, tuple)):
            if not isinstance(y, (list, tuple)) or len(x) != len(y):
                bad.append(where)
            else:
                for i, (u, v) in enumerate(zip(x, y)):
                    walk(u, v, f"{where}[{i}]")
        elif x != y:
            bad.append(where)

    walk(_state_to_host(a), _state_to_host(b), "state")
    return bad


def short_kernel_name(key: str) -> str:
    """A profiler kernel name without its return type and namespaces."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::"):
        key = key.replace(noise, "")
    return key[:110]


@contextlib.contextmanager
def plain_lookup():
    """Within this block the networks' lookups (the big nets' and the small
    net's split lookup) are the plain version (``torch.take``) instead of
    the kernel."""
    from gym2048_tpu_torch.models import ntuple, ntuple_big, table_gather

    saved = ntuple_big.gather_values, ntuple.gather_values
    ntuple_big.gather_values = ntuple.gather_values = table_gather.gather_values_reference
    try:
        yield
    finally:
        ntuple_big.gather_values, ntuple.gather_values = saved


def timed_chunks(trainer, state, chunks: int):
    """Run ``chunks`` chunks after the given state at the config's
    ``alpha``, each host-timed to a device sync; returns the state, the
    seconds of each, and the last chunk's metrics."""
    secs = []
    for _ in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_chunk(state, trainer.cfg.alpha)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return state, secs, metrics


def cnn_flops_per_board(filters: int, blocks: int) -> float:
    """FLOPs (2 per multiply-add) of one ActorCritic forward on a 4 x 4
    board: the 3x3 convolutions (16 -> filters, then 2 per block) at 16
    positions and the two dense heads; BatchNorm and ReLU are left out."""
    macs = 16 * (16 * 9 * filters + 2 * blocks * 9 * filters * filters) + 16 * filters * 5
    return 2.0 * macs


def ppo_iteration_flops(cfg) -> float:
    """FLOPs of one PPO iteration counted from the code: ``n_steps + 1``
    forwards of ``n_envs`` boards in the rollout, and per epoch a forward
    and a backward (3 forwards' worth) of every sample in the update."""
    per_board = cnn_flops_per_board(cfg.filters, cfg.residual_blocks)
    return per_board * ((cfg.n_steps + 1) * cfg.n_envs + 3 * cfg.n_epochs * cfg.rollout_size)


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's TF32 for float32 set to ``enabled`` within the
    block, restored after (torch's defaults: cuDNN on, cuBLAS off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| of tensor pairs, on the
    host in float64."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        check(g.shape == w.shape and g.dtype == w.dtype, "shape or dtype differs")
        w = w.detach().cpu().double()
        diff = (g.detach().cpu().double() - w).abs().max().item()
        worst = max(worst, diff / max(w.abs().max().item(), 1e-30))
    return worst


@contextlib.contextmanager
def timed_methods(cls, names):
    """:class:`SyncTimer` over methods of a class (every instance's calls),
    the methods restored on exit."""
    saved = {name: cls.__dict__[name] for name in names}
    try:
        yield SyncTimer(cls, names)
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


@contextlib.contextmanager
def quiet(log_path: str):
    """The standard output of a CLI appended to ``log_path``, not printed."""
    with open(log_path, "a") as log, contextlib.redirect_stdout(log):
        yield


def value_boards(boards_exp: np.ndarray) -> np.ndarray:
    e = boards_exp.astype(np.int64)
    return np.where(e > 0, np.left_shift(1, e), 0)


def legal_chance(boards: np.ndarray) -> tuple[float, float]:
    """The best accuracy and cross-entropy of a predictor of a uniformly
    random legal move on value ``boards``: the means of 1 / (legal moves)
    and of ln(legal moves)."""
    from gym2048_tpu_torch.core import rules_np

    n_legal = sum(rules_np.move_batch(boards, np.full(len(boards), d))[2].astype(int)
                  for d in range(4))
    return float(np.mean(1.0 / n_legal)), float(np.mean(np.log(n_legal)))


def check_transitions(td, steps: int) -> tuple[int, int]:
    """The rows of a self-play ``TrainingData`` in per-env order, ``steps``
    rows an env, no row dropped: each row a legal move whose next board is
    ``rules_np``'s result plus exactly one 2 or 4 on an empty cell, its
    reward the merge score; within an env each row's board is the previous
    next board, or after a done a fresh board of two tiles of 2 or 4.
    Returns ``(rows, done rows)``."""
    from gym2048_tpu_torch.core import rules_np

    x, nx = td.get_x(), td.get_next_x()
    a, r = td.get_y_digit().reshape(-1), td.get_reward().reshape(-1)
    d = td.get_done().reshape(-1)
    n = len(x)
    check(n % steps == 0, f"{n} rows, not a multiple of {steps} steps")
    new, score, changed = rules_np.move_batch(x, a)
    check(bool(changed.all()), f"{int((~changed).sum())} illegal rows")
    check(np.array_equal(r, score.astype(np.float64)), "a reward is not the merge score")
    spawn = nx - new
    cells = (spawn != 0).sum(axis=(1, 2))
    check(bool((cells == 1).all()), "a next board is not the move plus one tile")
    check(bool(np.isin(spawn.sum(axis=(1, 2)), (2, 4)).all()), "a spawned tile is not 2 or 4")
    check(bool((new[spawn != 0] == 0).all()), "a tile spawned on an occupied cell")
    follow = np.ones(n, bool)
    follow[steps - 1::steps] = False  # the last row of each env has no successor here
    idx = np.nonzero(follow)[0]
    cont = idx[~d[idx]]
    check(np.array_equal(x[cont + 1], nx[cont]), "an episode is not contiguous within its env")
    fresh = x[idx[d[idx]] + 1]
    check(bool(((fresh > 0).sum(axis=(1, 2)) == 2).all()
               and np.isin(fresh[fresh > 0], (2, 4)).all()), "a board after a done is not fresh")
    return n, int(d.sum())


class SyncTimer:
    """Wrap methods of an object so that each call is host-timed to a
    device sync; ``seconds[name]`` lists the calls' seconds."""

    def __init__(self, obj, names):
        self.seconds = {name: [] for name in names}
        for name in names:
            setattr(obj, name, self._timed(name, getattr(obj, name)))

    def _timed(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return timed


def profile_device(fn) -> tuple[float, float, int, list[tuple[str, float]]]:
    """``torch.profiler`` over one call of ``fn``: ``(wall us, device busy
    us, device kernels, the five largest kernels with their share of the
    busy time)``; busy 0 if the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:5]
    return (wall_us, busy, sum(e.count for e in device),
            [(short_kernel_name(e.key), e.self_device_time_total / max(busy, 1e-30))
             for e in top])


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
        counts it made (added to those of earlier drives of the path) and
        check that it launched each of its kernels."""
        self.zero_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = self.launches()
        self.zero_launches()
        for name, n in self.path_launches.get(path, {}).items():
            counts[name] += n
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
        from gym2048_tpu_torch import _build, _sass

        paths = _build.build_all()
        self.issue = {}
        for name, path in paths.items():
            _build.library(name)
            self.issue.update(_sass.issue_counts(_sass.dump(path)))
        self.usage = {}
        for path in paths.values():
            listing = subprocess.run([_sass.find_cuobjdump(), "-res-usage", str(path)],
                                     capture_output=True, text=True, check=True).stdout
            self.usage.update(resource_usage(listing))
        counts = {name: self.issue[sass] for name, (_, _, sass) in KERNELS.items()}
        counts["gather1_kernel"] = self.issue["gather1_kernel"]
        return (f"{', '.join(p.name for p in paths.values())}, one nvcc "
                f"{' '.join(_build.NVCC_FLAGS)} per source, started together; "
                f"fewest SASS instructions per thread "
                + ", ".join(f"{k} {c.outside}" + (f" + {c.per_iteration}/iteration"
                                                  if c.per_iteration else "")
                            for k, c in counts.items()))

    # 2b
    def registers(self) -> str:
        """Registers, stack, blocks per SM and waves of the fused library's
        kernels, from ``cuobjdump -res-usage`` of the built library."""
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        parts = []
        for name, threads in BLOCK_THREADS.items():
            kernel = KERNELS[name][2]
            check(kernel in self.usage, f"no resource usage for {kernel}")
            regs, stack = self.usage[kernel]["REG"], self.usage[kernel]["STACK"]
            per_sm = blocks_per_sm(regs, threads)
            text = (f"{kernel} {regs} registers, {stack} B stack, blocks of {threads}: "
                    f"{per_sm} blocks ({per_sm * threads // 32} warps) per SM")
            if name in ("fused_move", "fused_step_uniform"):
                waves = [math.ceil(math.ceil(b / threads) / (per_sm * sms)) for b in (SMALL_B, FULL_B)]
                text += (f", {math.ceil(SMALL_B / threads)} blocks = {waves[0]} wave(s) at "
                         f"B={SMALL_B}, {waves[1]} at B={FULL_B}")
            if name == "fused_rollout":
                blocks = math.ceil(FULL_B / threads)
                text += (f", {blocks} blocks = {blocks / (per_sm * sms):.2f} waves at B={FULL_B} "
                         f"({blocks / sms:.2f} blocks per SM)")
            parts.append(text)
        for kernel in ("gather4_kernel", "gather1_kernel"):
            check(kernel in self.usage, f"no resource usage for {kernel}")
            regs, stack = self.usage[kernel]["REG"], self.usage[kernel]["STACK"]
            # the scalar kernel's launch: index and output 4 bytes apart
            blocks = {n: gather_launches(n, 0, 0 if kernel == "gather4_kernel" else 4)[0][2]
                      for n in GATHER_SIZES}
            per_sm = blocks_per_sm(regs, GATHER_THREADS)
            parts.append(
                f"{kernel} {regs} registers, {stack} B stack, blocks of {GATHER_THREADS}: "
                f"{per_sm} blocks ({per_sm * GATHER_THREADS // 32} warps) per SM, blocks "
                f"(waves) at N=" + ", ".join(f"{n}: {b} ({b / (per_sm * sms):.2f})"
                                             for n, b in blocks.items()))
        return f"cuobjdump -res-usage, {sms} SMs: " + "; ".join(parts)

    def ops(self, kernel: str, threads: int, iterations: int = 0) -> int:
        """Thread instructions ``threads`` threads of ``kernel`` issue at least."""
        return threads * self.issue[KERNELS[kernel][2]].per_thread(iterations)

    def gather_ops(self, idx: torch.Tensor, out: torch.Tensor) -> int:
        """Thread instructions the lookup of ``idx`` into ``out`` issues at
        least: the fewest of a thread, times the threads launched."""
        ops = 0
        for vector, _, blocks in gather_launches(idx.numel(), idx.data_ptr(), out.data_ptr()):
            count = self.issue["gather4_kernel" if vector else "gather1_kernel"]
            # a kernel with a loop would need its iterations counted as well
            check(count.per_iteration == 0, "the gather kernels have no loop")
            ops += blocks * GATHER_THREADS * count.outside
        return ops

    def measure_gather(self, table: torch.Tensor, idx: torch.Tensor, reps: int = 20,
                       cold: bool = True, plain: bool = True) -> dict:
        """The lookup of ``idx`` on ``table``, held bit for bit against the
        plain version; the kernel's and ``torch.take``'s device time warm
        (a graph replay) and, with ``cold``, after the L2 is flushed; the
        plain version's; the distinct 32-B sectors of the stream and the
        bound (8 B per index, 32 B per distinct sector, the issue term).
        Each device time is the median of three graphs, each
        captured anew: where a capture places the outputs moves the time
        of a small lookup by a few percent."""
        tg = self.tg
        got = tg.gather_values(table, idx)
        want = tg.gather_values_reference(table, idx)
        err = max_abs_err([got], [want])
        check(err == 0.0 and torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"gather_values differs from plain by {err} at N={idx.numel()}")
        idx64 = idx.long()
        n = idx.numel()
        sectors = torch.unique(idx // 8).numel()
        r = dict(n=n, max_abs_err=err, sectors=sectors,
                 ms=median_of(lambda: graph_ms(lambda: tg.gather_values(table, idx), reps)),
                 library_ms=median_of(lambda: graph_ms(lambda: torch.take(table, idx64), reps)))
        r["bound_ms"], r["bound_by"] = bound(self.gather_ops(idx, got), 8 * n + 32 * sectors)
        if cold:
            flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=self.dev)
            r["cold_ms"] = median_of(lambda: cold_graph_ms(
                lambda: tg.gather_values(table, idx), lambda: flush.fill_(1.0), reps))
            r["library_cold_ms"] = median_of(lambda: cold_graph_ms(
                lambda: torch.take(table, idx64), lambda: flush.fill_(1.0), reps))
            del flush
        if plain:
            r["plain_ms"] = event_ms(lambda: tg.gather_values_reference(table, idx), 5)
        del got, want, idx64
        return r

    def gather_offsets(self, table: torch.Tensor, gen) -> str:
        """The library's launches for index and output pointers 0-3
        elements past a 16-byte boundary, each on its own (the 16-byte
        groups alone, with a scalar head and tail, or the scalar kernel over
        all), bit for bit against the plain version. The wrapper allocates
        its output, so the library is called directly here."""
        from gym2048_tpu_torch import _build

        lib = _build.library("table_gather")
        n = (1 << 20) + 3
        idx = torch.randint(0, table.numel(), (n + 3,), generator=gen, device=self.dev,
                            dtype=torch.int32)
        out = torch.empty(n + 3, dtype=torch.float32, device=self.dev)
        for a in range(4):
            want = torch.take(table, idx[a:a + n].long())
            for b in range(4):
                out.fill_(float("nan"))
                err = lib.gym_gather_values(table.data_ptr(), idx[a:].data_ptr(),
                                            out[b:].data_ptr(), n,
                                            torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"launch failed with error {err}")
                check(torch.equal(out[b:b + n].view(torch.int32), want.view(torch.int32)),
                      f"gather_values differs from plain at offsets {a}, {b}")
        return f"N={n} at index and output offsets 0-3 x 0-3 elements: bit-exact"

    @staticmethod
    def gather_text(r: dict) -> str:
        text = (f"N={r['n']}: bit-exact, kernel {r['ms']:.5f} ms warm"
                + (f", {r['cold_ms']:.5f} cold" if "cold_ms" in r else "")
                + f"; torch.take {r['library_ms']:.5f} warm"
                + (f", {r['library_cold_ms']:.5f} cold" if "library_cold_ms" in r else "")
                + (f"; plain {r['plain_ms']:.4f}" if "plain_ms" in r else "")
                + f"; {r['sectors']} distinct 32-B sectors ({r['sectors'] / r['n']:.4f} per "
                f"index, {32 * r['sectors'] / r['ms'] / 1e6:.1f} GB/s of them warm); bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f} warm")
        if "cold_ms" in r:
            text += f", {r['bound_ms'] / r['cold_ms']:.3f} cold"
        return text

    def record_gather(self, r: dict) -> None:
        """``r`` is the kernels line's row of gather_values."""
        self.kernels["gather_values"].update(
            {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")})

    # 3
    def philox(self) -> str:
        ctr = torch.tensor([k[0] for k in PHILOX_KAT], dtype=torch.int64, device=self.dev)
        key = torch.tensor([k[1] for k in PHILOX_KAT], dtype=torch.int64, device=self.dev)
        got = self.fs.philox4x32(ctr, key)
        check(got.tolist() == [list(k[2]) for k in PHILOX_KAT], f"Philox KAT {got.tolist()}")
        check(torch.equal(got, self.fs.philox4x32_reference(ctr, key)), "Philox vs plain")
        return "3 Random123 known answers match, kernel == plain"

    def time_sizes(self, name: str, fn, small: tuple, nbytes_per_board: float,
                   extra_bytes: float = 0.0) -> str:
        """Device ms of ``fn(*small)`` in a CUDA graph at B = SMALL_B (the
        row's number, into the kernels record) and at three more sizes, the
        inputs cut or tiled: SMALL_B / 64, where every board is in flight at
        once (the fixed cost of a launch); 2 * SMALL_B, whose working set,
        like SMALL_B's, stays in the 50 MB L2 across a replay (the two give
        the per-board cost there and the intercept); and FULL_B, past the
        L2, where the bytes come from HBM. ``extra_bytes`` is data-dependent
        traffic at SMALL_B, scaled with B."""
        ms = {}
        for b in (SMALL_B // 64, SMALL_B, 2 * SMALL_B, FULL_B):
            args = tuple(t[..., :b].contiguous() if b <= SMALL_B
                         else t.repeat(*([1] * (t.dim() - 1)), b // SMALL_B) for t in small)
            ms[b] = graph_ms(lambda: fn(*args), 100 if b <= 2 * SMALL_B else 20)
            del args
        rec = self.kernels[name]
        rec["ms"] = ms[SMALL_B]
        rec["bound_ms"], rec["bound_by"] = bound(
            self.ops(name, SMALL_B), SMALL_B * nbytes_per_board + extra_bytes)
        l2_per_board = (ms[2 * SMALL_B] - ms[SMALL_B]) / SMALL_B
        intercept_us = (ms[SMALL_B] - SMALL_B * l2_per_board) * 1e3
        terms = {b: bound_terms(self.ops(name, b), b * nbytes_per_board + extra_bytes * b / SMALL_B)
                 for b in (SMALL_B, FULL_B)}
        return (f"device ms " + ", ".join(f"{ms[b]:.5f} at B={b}" for b in ms)
                + f"; B={SMALL_B}: bound {rec['bound_ms']:.5f} ({rec['bound_by']}; issue "
                f"{terms[SMALL_B][0]:.5f}, bytes {terms[SMALL_B][1]:.5f}), share "
                f"{rec['bound_ms'] / rec['ms']:.3f}; B={FULL_B}: issue {terms[FULL_B][0]:.5f}, "
                f"bytes {terms[FULL_B][1]:.5f}, share {max(terms[FULL_B]) / ms[FULL_B]:.3f}, "
                f"{FULL_B * nbytes_per_board / ms[FULL_B] / 1e9:.3f} TB/s; fixed cost "
                f"{ms[SMALL_B // 64] * 1e3:.3f} us (B={SMALL_B // 64}), L2-resident "
                f"{l2_per_board * 1e9:.3f} us per million boards + {intercept_us:.3f} us, "
                f"HBM {ms[FULL_B] / FULL_B * 1e9:.3f} us per million boards")

    # 4
    def fused_move(self) -> str:
        fs = self.fs
        boards, family = adversarial_boards(self.rng, SMALL_B)
        cm = self.step_cm = fs.to_cell_major(torch.as_tensor(boards, device=self.dev))
        err, legal = 0.0, []
        for a in range(4):
            act = torch.full((SMALL_B,), a, dtype=torch.int32, device=self.dev)
            want = fs.fused_move_reference(cm, act)
            err = max(err, max_abs_err(fs.fused_move(cm, act), want))
            legal.append(want[2].cpu().numpy())
        # actions outside 0..2 act as 3
        odd = torch.as_tensor(self.rng.integers(-2, 7, SMALL_B, dtype=np.int32), device=self.dev)
        err = max(err, max_abs_err(fs.fused_move(cm, odd), fs.fused_move_reference(cm, odd)))
        check(err == 0.0, f"fused_move differs from plain by {err}")
        self.kernels["fused_move"]["max_abs_err"] = err
        # the families are what they claim to be
        n_legal = np.sum(legal, axis=0)
        full = (cm != 0).all(0).cpu().numpy()
        fam = {f: family == i for i, f in enumerate(BOARD_FAMILIES)}
        check((n_legal[fam["dead"]] == 0).all() and full[fam["dead"]].all(), "a 'dead' board moves")
        check((n_legal[fam["one legal direction"]] == 1).all(), "a 'one legal' board has not one")
        check(full[fam["full, merge only"]].all() and (n_legal[fam["full, merge only"]] > 0).all(),
              "a 'full, merge only' board is not full or cannot move")
        self.n_legal = n_legal
        act = torch.as_tensor(self.rng.integers(0, 4, SMALL_B, dtype=np.int32), device=self.dev)
        call_ms = event_ms(lambda: fs.fused_move(cm, act), 100)
        plain_ms = event_ms(lambda: fs.fused_move_reference(cm, act), 5)
        self.kernels["fused_move"]["plain_ms"] = plain_ms
        # read: board, action; write: board, score, legal
        timing = self.time_sizes("fused_move", fs.fused_move, (cm, act), 64 + 4 + 64 + 4 + 4)
        return (f"{SMALL_B} boards ({', '.join(BOARD_FAMILIES)}; {int((n_legal == 0).sum())} "
                f"dead, {int((n_legal == 1).sum())} with one legal direction), 4 actions and "
                f"actions -2..6: bit-exact (tolerance 0); random actions: {timing}; "
                f"{call_ms:.4f} ms per call from Python; plain {plain_ms:.3f} ms")

    # 5
    def fused_step_uniform(self) -> str:
        fs = self.fs
        cm = self.step_cm  # phase 4's boards
        u = torch.as_tensor(self.rng.random((8, SMALL_B), dtype=np.float32), device=self.dev)
        dead = torch.as_tensor(self.n_legal == 0, device=self.dev)
        err, wins = 0.0, {}
        for mte in (0, 2, 11, 17):
            got = fs.fused_step_uniform(cm, u, max_tile_exp=mte)
            err = max(err, max_abs_err(got, fs.fused_step_uniform_reference(cm, u, mte)))
            won = (got[2] == 1) & ~dead
            # a win the move did not make: the spawn placed the tile
            before_spawn = fs.fused_move_reference(cm, got[3])[0]
            by_spawn = won & ~(before_spawn == mte).any(0)
            wins[mte] = (int(won.sum().item()), int(by_spawn.sum().item()))
            if mte == 0:
                check(torch.equal(got[2] == 1, dead), "finished boards are not the dead ones")
        check(err == 0.0, f"fused_step_uniform differs from plain by {err}")
        self.kernels["fused_step_uniform"]["max_abs_err"] = err
        check(wins[2][1] > 0, "no win by spawn with max_tile_exp=2")
        check(wins[11][0] > 0 and wins[17][0] > 0, f"no win with max_tile_exp 11 or 17: {wins}")
        call_ms = event_ms(lambda: fs.fused_step_uniform(cm, u), 100)
        plain_ms = event_ms(lambda: fs.fused_step_uniform_reference(cm, u), 5)
        self.kernels["fused_step_uniform"]["plain_ms"] = plain_ms
        # read: board and u rows 0-2, rows 3-4 only where a board resets
        # (max_tile_exp 0, as timed: the dead boards); write: board, score,
        # finished, action
        resets = int(dead.sum().item())
        timing = self.time_sizes("fused_step_uniform", fs.fused_step_uniform, (cm, u),
                                 64 + 12 + 64 + 12, extra_bytes=8 * resets)
        return (f"{SMALL_B} boards of phase 4, max_tile_exp 0, 2, 11, 17 (wins, of them by "
                f"the spawn: {wins}): bit-exact (tolerance 0); max_tile_exp 0, {resets} resets: "
                f"{timing}; {call_ms:.4f} ms per call from Python; plain {plain_ms:.3f} ms")

    # 6
    def fused_rollout_small(self) -> str:
        """The rollout against its plain version on random boards, and for
        32 steps from phase 4's eight families (exponents up to 17, dead
        and merge-only boards, wins by the spawn) at four win exponents."""
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
        episodes = {}
        for mte in (0, 2, 11, 17):
            got = fs.fused_rollout(self.step_cm, SEED + mte, 32, 1024, mte)
            err = max_abs_err(got, fs.fused_rollout_reference(self.step_cm, SEED + mte, 32, mte))
            check(err == 0.0, f"fused_rollout on the families at max_tile_exp {mte} differs "
                  f"from plain by {err}")
            episodes[mte] = int(got[2].sum().item())
            check(episodes[mte] > 0, f"no episode ended at max_tile_exp {mte}")
        return (f"B=4096 T=64: bit-exact in all 4 outputs; plain {plain_s * 1e3:.1f} ms; "
                f"phase 4's {SMALL_B} boards x 32 steps at max_tile_exp 0, 2, 11, 17 "
                f"(episodes {episodes}): bit-exact in all 4 outputs")

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
        # sums of the four outputs, to hold two trees' rollouts side by side
        checksum = (board.sum(dtype=torch.int64).item(), eps,
                    score.double().sum().item(), total.double().sum().item())
        return (f"rollout B={FULL_B} T={FULL_T}: episode length {ep_len:.2f}, "
                f"score/step {per_step:.3f}, {distinct} distinct boards; checksum (board, "
                f"episodes, score, total) {checksum[0]} {checksum[1]} {checksum[2]!r} "
                f"{checksum[3]!r}; launches {self.path_launches['rollout']}")

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
            warp_resets = torch.zeros((), dtype=torch.int64, device=self.dev)
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
                # warps of the rollout (32 neighbouring boards) with a reset
                warp_resets += fin.view(-1, 32).any(1).sum()
                rb = new
            return rb, rscore, reps, rtotal, bad, warp_resets

        rb, rscore, reps, rtotal, bad, warp_resets = self.drive("step replay", replay)
        check(bad.item() == 0, f"{bad.item()} replayed steps broke the move check")
        board, score, episodes, total = self.full_out
        err = max_abs_err((rb, rscore, reps, rtotal),
                          (board[:, :n], score[:n], episodes[:n], total[:n]))
        check(err == 0.0, f"step replay differs from the rollout by {err}")
        warp_share = warp_resets.item() / (n // 32 * FULL_T)
        return (f"{n} boards x {FULL_T} steps: bit-exact against the rollout, "
                f"every move checked; resets in {reps.sum().item() / (n * FULL_T):.5f} of "
                f"board-steps and {warp_share:.4f} of warp-steps (the rollout's reset "
                f"branch); launches {self.path_launches['step replay']}")

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
        count = self.issue[KERNELS["fused_rollout"][2]]
        return (f"{rate:.6e} steps/s (median of {TIMED_RUNS}, "
                f"spread {FULL_B * FULL_T / times[-1]:.6e}-{FULL_B * FULL_T / times[0]:.6e}) "
                f"on {self.smi}; rollout kernel {rec['ms']:.3f} ms (spread "
                f"{times[0] * 1e3:.3f}-{times[-1] * 1e3:.3f}) vs plain {rec['plain_ms']:.1f} ms, "
                f"bit-exact; {count.per_iteration} SASS instructions per step + "
                f"{count.outside}: bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}), share "
                f"{rec['bound_ms'] / rec['ms']:.3f}; against the four-move step's bound "
                f"{ROLLOUT_BOUND_4MOVE_MS:.3f} ms {ROLLOUT_BOUND_4MOVE_MS / rec['ms']:.3f}, "
                f"against its one-move estimate {ROLLOUT_BOUND_1MOVE_EST_MS:.3f} ms "
                f"{ROLLOUT_BOUND_1MOVE_EST_MS / rec['ms']:.3f}; uniform rows {shape} kernel "
                f"{urec['ms']:.4f} ms vs plain {urec['plain_ms']:.1f} ms, bit-exact")

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
        """The lookup kernel on the flagship table at full width: a uniform
        index stream at four sizes, and the stream a depth-2 search reads,
        warm and cold."""
        from gym2048_tpu_torch.models import ntuple_big

        net = ntuple_big.make_network(AGENT_ARCH, AGENT_N_VALS, AGENT_THRESHOLDS)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        table = torch.randn(net.table_size, generator=gen, device=self.dev).mul_(100.0)
        self.net, self.table = net, table
        parts = []
        for n in GATHER_SIZES:
            idx = torch.randint(0, net.table_size, (n,), generator=gen, device=self.dev,
                                dtype=torch.int32)
            r = self.measure_gather(table, idx, reps=100 if n <= 1 << 20 else 20 if n <= 1 << 23
                                    else 5, cold=False, plain=n == GATHER_UNIFORM_N)
            parts.append("uniform " + self.gather_text(r))
            del idx
        parts.append(self.gather_offsets(table, gen))
        real = net.indices_batch(leaf_afterstates(self.leaf_roots)).reshape(-1)
        check(real.numel() == LEAF_BOARDS * 512 * net.n_features,
              f"real stream of {real.numel()} indices")
        r = self.measure_gather(table, real)
        parts.append("real (depth-2 leaves) " + self.gather_text(r))
        self.record_gather(r)
        del real
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
        of each of the 8192 boards of the learner's state, warm and cold."""
        idx, text = self.td_stream(self.td_trainer._net, self.td_state)
        r = self.measure_gather(self.td_state["table"], idx)
        self.record_gather(r)
        return (f"{text}: {self.gather_text(r)}; "
                f"{self.path_launches['td']['gather_values']} launches per chunk")

    @staticmethod
    def td_stream(net, state: dict) -> tuple[torch.Tensor, str]:
        """The indices a TD step looks up for ``state``'s boards: each
        board's four afterstates."""
        from gym2048_tpu_torch.core import rules

        boards = state["boards"]
        moved = rules.move_all(boards)[0].reshape(-1, 4, 4)
        idx = net.indices_batch(moved).reshape(-1)
        check(idx.numel() == 4 * boards.shape[0] * net.n_features,
              f"TD stream of {idx.numel()} indices")
        return idx, f"4 afterstates x {boards.shape[0]} boards x {net.n_features}"

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
            return self.replay_chunk(tr, self.td_state, lookup, deterministic, 1)

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

    def replay_chunk(self, tr, state: dict, lookup: str, deterministic: bool,
                     lookups_per_step: int):
        """One chunk of ``tr`` from a copy of ``state`` with the lookup kernel
        or the plain lookup, in deterministic mode or not; checks the
        kernel's launches and returns the state and the chunk's seconds."""
        launched = self.tg.LAUNCHES["gather_values"]
        torch.use_deterministic_algorithms(deterministic)
        try:
            with plain_lookup() if lookup == "plain" else contextlib.nullcontext():
                state, secs, _ = timed_chunks(tr, clone_state(state), 1)
        finally:
            torch.use_deterministic_algorithms(False)
        kernel_launches = self.tg.LAUNCHES["gather_values"] - launched
        want = tr.cfg.chunk_steps * lookups_per_step if lookup == "kernel" else 0
        check(kernel_launches == want, f"{kernel_launches} kernel launches in the {lookup} "
              f"run, not {want}")
        return state, secs[0]

    def profile_chunk(self, tr, state: dict) -> tuple[str, dict[str, float]]:
        """``torch.profiler`` over one chunk of ``tr`` from a copy of
        ``state`` (device events only): its text (the device's busy share,
        kernels per step, top kernels) and the device us by kernel."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        steps = tr.cfg.chunk_steps
        state = clone_state(state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_chunk(state, tr.cfg.alpha)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        busy = sum(device_us.values())
        if not busy:
            return "torch.profiler recorded no device time: busy share not measured", {}
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
        return (f"wall {wall_us / steps / 1e3:.3f} ms per step under the profiler, device "
                f"busy {busy / steps / 1e3:.3f} ms per step ({busy / wall_us:.4f} of the "
                f"wall time), {launches / steps:.1f} device kernels per step, "
                f"{len(device_us)} distinct; top: "
                + "; ".join(f"{short_kernel_name(k)} {us / busy:.3f}" for k, us in top),
                device_us)

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
        from gym2048_tpu_torch.models.ntuple import _tc_combine

        tr, state = self.td_trainer, clone_state(self.td_state)
        steps = tr.cfg.chunk_steps
        profiled, device_us = self.profile_chunk(tr, state)
        busy = sum(device_us.values())
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
        # the lookup on the trained learner's own stream, into its own table
        idx, text = self.td_stream(tr._net, state)
        self.late_stream = (state["table"], idx)
        late = self.gather_text(self.measure_gather(state["table"], idx))
        return (f"{cfg.arch} TC unstaged, {cfg.n_envs} envs, {cfg.total_steps} steps in "
                f"{secs:.2f} s ({cfg.total_steps / secs:.1f} steps/s): ep_score_mean {curve}; "
                f"the last in [{lo:.0f}, {hi:.0f}], highest tile {last.highest_tile_max}; "
                f"late TD stream ({text}, table of {tr._net.table_size}): {late}")

    # 17a
    def td_small_path(self) -> str:
        """The small net's TD learner at full width, one chunk, driven as path
        "td small": one lookup kernel launch per step."""
        from gym2048_tpu_torch.train import td

        cfg = td.TDConfig(**TD_SMALL)
        self.small_trainer = tr = td.TDTrainer(cfg, device=self.dev)
        check(tr._net is None and tr._small.value_impl == "gather", "not the small net's lookup")
        state = tr.init_state()
        t0 = time.perf_counter()
        state, m = self.drive("td small", lambda: tr.train_chunk(state, cfg.alpha))
        secs = time.perf_counter() - t0
        launches = self.path_launches["td small"]["gather_values"]
        check(launches == cfg.chunk_steps, f"{launches} lookups in a {cfg.chunk_steps}-step chunk")
        check(all(torch.isfinite(state[k]).all().item() for k in ("table", "tc_e", "tc_a")),
              "non-finite table or accumulators")
        moved = (state["table"] != cfg.init_value / 17).sum().item()
        check(moved > 0, "the chunk did not move the table")
        self.small_state = state
        return (f"small 17x4 net, {state['table'].numel()} f32 x 3 (table, tc_e, tc_a), "
                f"{cfg.n_envs} envs, TC, value_impl {cfg.value_impl}: first chunk of "
                f"{cfg.chunk_steps} steps in {secs:.3f} s (allocation included), "
                f"{m['episodes'].item():.0f} episodes, highest exponent "
                f"{m['highest_exp'].item()}, {moved} entries moved; launches "
                f"{self.path_launches['td small']}")

    # 17b
    def td_small_gather(self) -> str:
        """The lookup kernel on the small TD step's stream: the 4 afterstates
        of each of the 8192 boards, 136 lookups each, into the 5.7 MB table
        (it fits in the L2), warm and cold."""
        from gym2048_tpu_torch.models import ntuple

        idx, text = self.td_stream(ntuple.network(), self.small_state)
        r = self.measure_gather(self.small_state["table"], idx)
        return (f"{text}: {self.gather_text(r)}; "
                f"{self.path_launches['td small']['gather_values']} launches per chunk")

    # 17c
    def td_small_replay(self) -> str:
        """16-step small chunks from the learner's state with the lookup kernel
        and with the plain lookup, in deterministic mode, with the exact
        lookup and with the split one (two lookups a step): every leaf of
        the state equal bit for bit."""
        import dataclasses

        from gym2048_tpu_torch.train import td

        parts = []
        for impl, per_step in (("auto", 1), ("mxu", 2)):
            cfg = dataclasses.replace(self.small_trainer.cfg, chunk_steps=TD_REPLAY_STEPS,
                                      value_impl=impl)
            tr = td.TDTrainer(cfg, device=self.dev)
            kernel, kernel_s = self.replay_chunk(tr, self.small_state, "kernel", True, per_step)
            plain, plain_s = self.replay_chunk(tr, self.small_state, "plain", True, per_step)
            bad = state_diffs(kernel, plain)
            check(not bad, f"value_impl {impl}: the plain-lookup chunk differs in {bad}")
            moved = (kernel["table"] != self.small_state["table"]).sum().item()
            check(moved > 0, "the replayed chunk did not move the table")
            parts.append(f"value_impl {impl} ({per_step * TD_REPLAY_STEPS} kernel launches): "
                         f"identical in all {len(kernel)} leaves, {moved} entries moved, "
                         f"{kernel_s:.3f} s kernel, {plain_s:.3f} s plain")
        return f"{TD_REPLAY_STEPS} steps x {TD_SMALL['n_envs']} envs, deterministic: " + "; ".join(parts)

    # 17d
    def td_small_throughput(self) -> str:
        """Steps/s of the small learner in three configs, and
        ``torch.profiler`` over one chunk of the first."""
        from gym2048_tpu_torch.train import td

        rates = "; ".join(self.td_rate(c, label) for c, label in (
            (TD_SMALL, "ntuple_table_tc1b config (TC, exact lookup)"),
            (TD_BENCH_SMALL, "bench_td (split lookup, alpha 0.1)"),
            ({}, "CLI defaults (TDConfig(): 4096 envs x 256)")))
        profiled, device_us = self.profile_chunk(self.small_trainer, self.small_state)
        busy = sum(device_us.values())
        lookup = sum(us for k, us in device_us.items()
                     if "gather4_kernel" in k or "gather1_kernel" in k)
        share = f"; the lookup kernel {lookup / busy:.4f} of the device time" if busy else ""
        return f"{rates}; on {self.smi}. One TC chunk profiled: {profiled}{share}"

    # 17e
    def td_small_learning(self) -> str:
        """80 chunks of docs/curves/td_mxu_run.jsonl's config from the
        optimistic table: the last chunk's episode score must lie in the
        band of the JAX runs."""
        from gym2048_tpu_torch.train import td

        cfg = td.TDConfig(**TD_SMALL_LEARN)
        tr = td.TDTrainer(cfg, device=self.dev)
        t0 = time.perf_counter()
        state, hist = tr.learn(log_every=20, log_fn=None, max_chunks=TD_SMALL_LEARN_CHUNKS)
        secs = time.perf_counter() - t0
        last = hist[-1]
        steps = TD_SMALL_LEARN_CHUNKS * cfg.n_envs * cfg.chunk_steps
        check(last.steps == steps, f"trained {last.steps} steps")
        check(torch.isfinite(state["table"]).all().item(), "non-finite table")
        lo, hi = TD_SMALL_LEARN_BAND
        check(lo <= last.ep_score_mean <= hi,
              f"ep_score_mean {last.ep_score_mean} at {last.steps} steps outside [{lo}, {hi}]")
        self.small_table = state["table"]
        curve = ", ".join(f"{e.steps}: {e.ep_score_mean:.1f} ({e.episodes:.0f} episodes, "
                          f"alpha {e.alpha:.4f})" for e in hist)
        return (f"small net, value_impl {cfg.value_impl}, {cfg.n_envs} envs, {steps} steps of "
                f"the {cfg.total_steps}-step schedule in {secs:.2f} s ({steps / secs:.1f} "
                f"steps/s): ep_score_mean {curve}; the last in [{lo:.0f}, {hi:.0f}] (JAX "
                f"37,584.1 and 39,778.5 there), highest tile {last.highest_tile_max}")

    # 17f
    def td_small_play(self) -> str:
        """The table phase 17e trained: greedy play (``play_greedy``, the
        exact lookup), and the expectimax CLI's small-table policy at depth
        2, its every live action legal and its first 128 moves as with the
        plain lookup."""
        from gym2048_tpu_torch.agents import expectimax as ex
        from gym2048_tpu_torch.models import ntuple
        from gym2048_tpu_torch.train import td

        table = self.small_table
        t0 = time.perf_counter()
        res = td.play_greedy(table, GREEDY_GAMES, torch.Generator(device=self.dev).manual_seed(SEED))
        greedy_s = time.perf_counter() - t0
        check(res["Average score"] >= GREEDY_MIN,
              f"greedy average {res['Average score']} below {GREEDY_MIN}")
        moves = sum(e["moves"] for e in res["Episodes"])

        net = ntuple.SmallNet("auto")  # the CLI's default: exact lookups
        params = net.params(table)
        pol = ex.make_afterstate_policy(net.value_batch, depth=2, parametrised=True)

        def play(record, cap):
            return ex.play_policy(record, SMALL_AGENT_GAMES,
                                  torch.Generator(device=self.dev).manual_seed(SEED), cap,
                                  AGENT_CHUNK, params=params, needs_active=True,
                                  device=self.dev)

        rec = MoveRecord(lambda p, b, active: pol(p, b))
        t0 = time.perf_counter()
        ares = play(rec, SMALL_AGENT_MOVE_CAP)
        agent_s = time.perf_counter() - t0
        n_moves = len(rec.actions)
        illegal, _, lengths = rec.replay(n_moves)
        check(illegal == 0, f"{illegal} illegal actions on live boards")
        check(lengths == [e["moves"] for e in ares["Episodes"]], "play_policy and the record disagree")
        plain = MoveRecord(lambda p, b, active: pol(p, b))
        launched = self.tg.LAUNCHES["gather_values"]
        with plain_lookup():
            play(plain, REPLAY_MOVES)
        check(self.tg.LAUNCHES["gather_values"] == launched, "the plain replay launched the kernel")
        check(n_moves >= REPLAY_MOVES and len(plain.actions) == REPLAY_MOVES, "replay length")
        check(torch.equal(torch.stack(rec.actions[:REPLAY_MOVES]), torch.stack(plain.actions)),
              f"actions differ from the plain lookup's within {REPLAY_MOVES} moves")
        check(rec.replay(REPLAY_MOVES) == plain.replay(REPLAY_MOVES),
              "scores or lengths differ from the plain replay")
        searched = sum(e["moves"] for e in ares["Episodes"])
        return (f"greedy, {GREEDY_GAMES} games: average {res['Average score']:.1f} (JAX greedy "
                f"at 150M steps: 46,949.2, td_eval.json), max {res['Max score']:.0f}, highest "
                f"tile {res['Highest tile']}, {moves} moves in {greedy_s:.2f} s; expectimax "
                f"depth 2, {SMALL_AGENT_GAMES} games, cap {SMALL_AGENT_MOVE_CAP}: average "
                f"{ares['Average score']:.1f}, {searched / agent_s:.1f} searched moves/s, "
                f"every live action legal, first {REPLAY_MOVES} moves identical to the plain "
                f"lookup's; on {self.smi}")

    # 19a
    def cnn_forward(self) -> str:
        """``entry()``'s ActorCritic(64, 4) in eval mode: its outputs at 256
        boards; the card against the port's CPU forward on the same weights
        with TF32 off; device ms per forward (a graph replay) at 256, 4096
        and 16,384 boards in f32 at torch's defaults (cuDNN TF32 on, cuBLAS
        off), f32 with TF32 off, and bf16."""
        import copy

        from gym2048_tpu_torch import entry
        from gym2048_tpu_torch.models import resnet

        fn, (model, boards) = entry.entry(device=self.dev)
        check(tuple(boards.shape) == (256, 4, 4) and boards.dtype == torch.int8
              and boards.device.type == self.dev.type, "entry()'s boards")
        check((model.filters, model.residual_blocks) == (CNN_FILTERS, CNN_BLOCKS)
              and not model.training, "entry()'s model")
        logits, value = fn(model, boards)
        check(tuple(logits.shape) == (256, 4) and tuple(value.shape) == (256,)
              and logits.dtype == value.dtype == torch.float32
              and bool(torch.isfinite(logits).all() & torch.isfinite(value).all()),
              "entry()'s outputs")
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == 310_405, f"{n_params} parameters, not 310,405")
        cpu_model = copy.deepcopy(model).cpu()
        rng = np.random.default_rng(SEED)
        errs = []
        with tf32(False):
            for n in FORWARD_CHECK_BATCHES:
                b = torch.as_tensor(random_boards(rng, n, 15, 0.4))
                errs.append(rel_err(fn(model, b.to(self.dev)), fn(cpu_model, b)))
        check(max(errs) <= 1e-5, f"card vs CPU forward: relative error {max(errs)}")
        bf16_model = resnet.ActorCritic(CNN_FILTERS, CNN_BLOCKS, torch.bfloat16, self.dev)
        bf16_model.load_state_dict(model.state_dict())
        per_board = cnn_flops_per_board(CNN_FILTERS, CNN_BLOCKS)
        parts = []
        for n in FORWARD_BATCHES:
            b = torch.as_tensor(random_boards(rng, n, 15, 0.4)).to(self.dev)
            reps = 20 if n <= 4096 else 5
            f32_ms = graph_ms(lambda: fn(model, b), reps)
            with tf32(False):
                strict_ms = graph_ms(lambda: fn(model, b), reps)
            bf16_ms = graph_ms(lambda: fn(bf16_model, b), reps)
            bf16_err = rel_err(fn(bf16_model, b)[:1], fn(model, b)[:1])
            parts.append(
                f"B={n}: f32 {f32_ms:.4f} ms ({per_board * n / f32_ms / 1e9:.1f} TFLOP/s), "
                f"f32 TF32 off {strict_ms:.4f} ms, bf16 {bf16_ms:.4f} ms "
                f"({per_board * n / bf16_ms / 1e9:.1f} TFLOP/s; logits within "
                f"{bf16_err:.3g} of f32's)")
        return (f"ActorCritic({CNN_FILTERS}, {CNN_BLOCKS}), {n_params} parameters, "
                f"{per_board / 1e6:.3f} MFLOP a board; card vs CPU (TF32 off) within "
                f"{max(errs):.3g} of the largest magnitude at B={FORWARD_CHECK_BATCHES} "
                f"(limit 1e-5); device ms per forward (graph replay; f32 at torch's "
                f"defaults, cuDNN TF32 on): " + "; ".join(parts) + f"; on {self.smi}")

    def ppo_rate(self, label: str, config: dict, dtype: torch.dtype, timed: int,
                 profile_steps: int) -> str:
        """One ``bench_ppo`` shape: env steps/s over ``timed`` host-timed
        iterations after a warm-up (median, spread), each synced once by
        reading its loss as ``learn`` reads its metrics; peak memory; the
        rollout's and the update's share of one further iteration, each
        timed to a device sync; the FLOPs of an iteration and their rate
        against the card's peak; and ``torch.profiler`` over one iteration
        of the shape cut to ``n_steps = profile_steps`` (rollout and SGD
        steps in the same ratio; its kernels scaled to the whole shape)."""
        from gym2048_tpu_torch.train import ppo

        cfg = ppo.PPOConfig(**config, compute_dtype=dtype)
        tr = ppo.PPO(cfg, device=self.dev)
        state = tr.init_state()
        if timed > 1:
            state, _ = tr.train_iteration(state)  # warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(timed):
            t0 = time.perf_counter()
            state, metrics = tr.train_iteration(state)
            check(math.isfinite(float(metrics["loss"])), f"{label}: loss not finite")
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rates = sorted(cfg.rollout_size / x for x in secs)
        timer = SyncTimer(tr, ("_collect_rollout", "_update_epochs"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_iteration(state)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        rollout = sum(timer.seconds["_collect_rollout"]) / total
        update = sum(timer.seconds["_update_epochs"]) / total
        flops = ppo_iteration_flops(cfg)
        achieved = flops / sorted(secs)[len(secs) // 2]
        peaks = (("bf16",) if dtype == torch.bfloat16 else ("f32", "tf32"))
        shares = ", ".join(f"{achieved / PEAK_FLOPS[k]:.4f} of the {k} peak" for k in peaks)
        prof_tr = ppo.PPO(ppo.PPOConfig(**{**config, "n_steps": profile_steps},
                                        compute_dtype=dtype), device=self.dev)
        prof_state, scale = prof_tr.init_state(), cfg.n_steps // profile_steps
        wall, busy, kernels, top = profile_device(lambda: prof_tr.train_iteration(prof_state))
        prof = ("torch.profiler recorded no device time: busy share not measured" if not busy
                else f"under torch.profiler at n_steps {profile_steps}: busy {busy / wall:.4f} "
                     f"of {wall / 1e6:.3f} s, {kernels} kernels an iteration ({kernels * scale} "
                     f"at n_steps {cfg.n_steps}); top: "
                     + "; ".join(f"{k} {v:.3f}" for k, v in top))
        return (f"{label}: {cfg.rollout_size / sorted(secs)[len(secs) // 2]:.1f} steps/s "
                f"(median of {timed}; {rates[0]:.1f}-{rates[-1]:.1f}), peak "
                f"{peak:.3f} GiB allocated ({peak - held:.3f} above the {held:.3f} held "
                f"before); one more iteration, its two parts timed to a sync: rollout "
                f"{rollout:.3f} and update {update:.3f} of {total:.3f} s; {flops / 1e12:.2f} TFLOP an iteration, {achieved / 1e12:.1f} TFLOP/s "
                f"({shares}); {prof}")

    # 19b
    def ppo_throughput(self) -> str:
        """``bench.py::bench_ppo``'s shapes: production in bf16 and f32, the
        reference (host-bound by design) for one iteration."""
        production, reference = PPO_PROFILE_STEPS
        parts = [self.ppo_rate("production bf16", PPO_PRODUCTION, torch.bfloat16,
                               PPO_TIMED_ITERATIONS, production),
                 self.ppo_rate("production f32", PPO_PRODUCTION, torch.float32,
                               PPO_TIMED_ITERATIONS, production),
                 self.ppo_rate("reference f32", PPO_REFERENCE, torch.float32, 1, reference)]
        return " | ".join(parts) + f"; on {self.smi}"

    # 19c
    def ppo_learning(self) -> str:
        """The config of ``docs/curves/ppo_tpu_config.jsonl`` for 12
        iterations (6,291,456 steps) as path "ppo": the first iteration in
        the untrained policy's band, the last two at least 150 and twice
        the first two."""
        from gym2048_tpu_torch.train import ppo

        cfg = ppo.PPOConfig(**PPO_LEARN)
        tr = ppo.PPO(cfg, device=self.dev)
        state = tr.init_state()
        rows = []

        def learn():
            nonlocal state
            for _ in range(PPO_LEARN_ITERATIONS):
                state, metrics = tr.train_iteration(state)
                rows.append({k: float(v) for k, v in metrics.items()})

        t0 = time.perf_counter()
        self.drive("ppo", learn)
        secs = time.perf_counter() - t0
        rets = [r["ep_return_mean"] for r in rows]
        first2, last2 = (rets[0] + rets[1]) / 2, (rets[-2] + rets[-1]) / 2
        check(PPO_FIRST_BAND[0] <= rets[0] <= PPO_FIRST_BAND[1],
              f"first ep_return_mean {rets[0]} outside {PPO_FIRST_BAND}")
        check(last2 >= PPO_LAST_MIN and last2 >= PPO_GAIN_MIN * first2,
              f"ep_return_mean {rets}: the last two do not reach {PPO_LAST_MIN} and "
              f"{PPO_GAIN_MIN}x the first two")
        self.ppo_model = state.model
        steps = PPO_LEARN_ITERATIONS * cfg.rollout_size
        return (f"{steps} steps in {secs:.2f} s ({steps / secs:.1f} steps/s); ep_return_mean "
                + ", ".join(f"{r:.1f}" for r in rets)
                + f" (JAX: 51.7, 58.3 ... 260.3, 277.2); first two {first2:.1f}, last two "
                f"{last2:.1f}; value_loss at the first iteration {rows[0]['value_loss']:.1f} "
                f"(JAX 90.3), highest_tile_mean at the last {rows[-1]['highest_tile_mean']:.1f}"
                f"; launches {self.path_launches['ppo']}")

    # 19d
    def bc_epoch(self) -> str:
        """``build_bc_trainer_for_ppo()`` for one epoch over 262,144 boards
        labelled by the synthetic rule, then ``evaluate``."""
        from gym2048_tpu_torch.train import bc

        trainer = bc.build_bc_trainer_for_ppo(device=self.dev)
        rng = np.random.default_rng(SEED)
        boards = rng.integers(0, 8, size=(BC_SAMPLES, 4, 4)).astype(np.int8)
        labels = boards.reshape(BC_SAMPLES, 16).argmax(axis=1) % 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = trainer.fit(boards, labels, epochs=1, verbose=False)
        secs = time.perf_counter() - t0
        ev = trainer.evaluate(boards, labels)
        check(ev["accuracy"] > BC_ACCURACY_MIN,
              f"BC accuracy {ev['accuracy']} not above {BC_ACCURACY_MIN}")
        return (f"one epoch of {BC_SAMPLES} boards, batch {trainer.cfg.batch_size}, lr "
                f"{trainer.cfg.lr}: loss {history[0]['loss']:.4f}, accuracy "
                f"{history[0]['accuracy']:.4f}, {BC_SAMPLES / secs:.1f} samples/s "
                f"({secs:.2f} s); evaluate: loss {ev['loss']:.4f}, accuracy "
                f"{ev['accuracy']:.4f} (chance 0.25, limit {BC_ACCURACY_MIN})")

    # 19e
    def ppo_evaluation(self) -> str:
        """``evaluate_batched`` of 19c's model over 512 episodes with and
        without the mask, and the critic as the leaf of a depth-1 search
        on 64 boards, its Q-values against the CPU's with TF32 off."""
        import copy

        from gym2048_tpu_torch.agents import expectimax as ex
        from gym2048_tpu_torch.train import eval as ev

        model = self.ppo_model.eval()
        parts = []
        for mask in (False, True):
            gen = torch.Generator(device=self.dev).manual_seed(SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ev.evaluate_batched(model, EVAL_EPISODES, 0.0, gen, mask_illegal=mask)
            secs = time.perf_counter() - t0
            eps = res["Episodes"]
            moves = [e["moves"] for e in eps]
            highest = [e["highest"] for e in eps]
            illegal = sum(e["illegal_moves"] for e in eps)
            check(len(eps) == EVAL_EPISODES and max(moves) <= ev.MOVE_CAP + 1
                  and min(moves) >= 1, f"moves outside [1, {ev.MOVE_CAP + 1}]")
            check(all(h >= 2 and h & (h - 1) == 0 for h in highest), "highest not a power of 2")
            check(not mask or illegal == 0, f"{illegal} illegal moves under the mask")
            parts.append(f"{'masked' if mask else 'unmasked'}: average {res['Average score']:.1f}, "
                         f"max {res['Max score']:.0f}, highest tile {res['Highest tile']}, "
                         f"{sum(moves)} moves (longest {max(moves)}), {illegal} illegal, "
                         f"{EVAL_EPISODES / secs:.1f} episodes/s")
        rng = np.random.default_rng(SEED)
        boards = torch.as_tensor(random_boards(rng, LEAF_BOARDS_CNN, 11, 0.4))
        cpu_model = copy.deepcopy(model).cpu()
        with tf32(False):
            q_card = ex.action_values(boards.to(self.dev), 1, ex.value_leaf_from_critic(model),
                                      1.0, ex.bellman_dead_value)
        q_cpu = ex.action_values(boards, 1, ex.value_leaf_from_critic(cpu_model), 1.0,
                                 ex.bellman_dead_value)
        legal = q_cpu > -1e8
        check(torch.equal(q_card.cpu() > -1e8, legal), "legal actions differ")
        err = rel_err((q_card.cpu()[legal],), (q_cpu[legal],))
        check(err <= 1e-5, f"critic-leaf Q-values: card vs CPU relative error {err}")
        policy = ex.make_policy(1, ex.value_leaf_from_critic(model), gain_weight=1.0,
                                dead_value=ex.bellman_dead_value)
        b = boards.to(self.dev)
        actions = policy(b).cpu().long()
        live = legal.any(-1)
        check(bool(legal[live].gather(1, actions[live, None]).all()), "an illegal policy action")
        ms = median_of(lambda: event_ms(lambda: policy(b), 10), 3)
        return (" | ".join(parts) + f"; critic leaf, depth 1 on {LEAF_BOARDS_CNN} boards "
                f"({LEAF_BOARDS_CNN * 128} leaves a call): Q-values within {err:.3g} of the "
                f"CPU's (TF32 off, limit 1e-5), {ms:.3f} ms a call, "
                f"{LEAF_BOARDS_CNN / ms * 1e3:.1f} moves/s")

    # 20a
    def shell_engine(self) -> str:
        """Which optional packages the card's host has (information, not a
        check), the native engine built with ``g++`` and
        ``engine_move_batch`` held bit for bit against ``rules_np`` (and
        ``rules_np.move`` one board at a time on a sample) and against
        ``core.rules`` on the card, on random and adversarial boards."""
        import importlib.util
        import shutil

        from gym2048_tpu_torch import native
        from gym2048_tpu_torch.core import rules, rules_np

        have = {m: importlib.util.find_spec(m) is not None
                for m in ("gymnasium", "PIL", "tensorboard")}
        gxx = shutil.which("g++")
        version = (subprocess.run([gxx, "--version"], capture_output=True, text=True)
                   .stdout.splitlines()[0] if gxx else "no g++")
        print(f"optional packages: " + ", ".join(f"{m} {'yes' if v else 'no'}"
                                                for m, v in have.items())
              + f"; {version}", flush=True)
        t0 = time.perf_counter()
        check(native.available(), f"the native engine did not build: {native._build_error}")
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        half = ENGINE_BOARDS // 2
        boards = np.concatenate([random_boards(rng, half, 15, 0.3),
                                 adversarial_boards(rng, ENGINE_BOARDS - half)[0]])
        actions = rng.integers(0, 4, ENGINE_BOARDS).astype(np.int32)
        t0 = time.perf_counter()
        moved, scores, legal = native.move_batch(boards, actions)
        engine_s = time.perf_counter() - t0
        values = value_boards(boards)
        t0 = time.perf_counter()
        new, np_scores, changed = rules_np.move_batch(values, actions)
        np_s = time.perf_counter() - t0
        check(np.array_equal(value_boards(moved), new) and np.array_equal(scores, np_scores)
              and np.array_equal(legal, changed), "engine_move_batch differs from rules_np")
        for i in rng.choice(ENGINE_BOARDS, RULES_NP_SAMPLE, replace=False):
            b, s, c = rules_np.move(values[i], int(actions[i]))
            check(np.array_equal(b, new[i]) and s == np_scores[i] and c == changed[i],
                  f"rules_np.move differs from move_batch on board {i}")
        b_t = torch.as_tensor(boards).to(self.dev)
        a_t = torch.as_tensor(actions).to(self.dev)
        t_moved, t_scores, t_legal = rules.apply_action(b_t, a_t)
        check(np.array_equal(t_moved.cpu().numpy(), moved)
              and np.array_equal(t_scores.cpu().numpy().astype(np.int64), scores.astype(np.int64))
              and np.array_equal(t_legal.cpu().numpy(), legal),
              "engine_move_batch differs from core.rules on the card")
        lib = native.LIBRARY
        return (f"{lib.relative_to(os.getcwd()) if lib.is_relative_to(os.getcwd()) else lib} "
                f"(g++ {' '.join(native.GXX_FLAGS)}) ready in {build_s:.2f} s; "
                f"engine_move_batch on {ENGINE_BOARDS} boards ({half} random exponents "
                f"0-15, {ENGINE_BOARDS - half} of the eight families) equal to "
                f"rules_np.move_batch, to rules_np.move on {RULES_NP_SAMPLE} of them, and "
                f"to core.rules.apply_action on the card, bit for bit ({int(legal.sum())} "
                f"legal); engine {ENGINE_BOARDS / engine_s / 1e6:.2f}M boards/s, rules_np "
                f"{ENGINE_BOARDS / np_s / 1e6:.2f}M boards/s on the host")

    def shell_cli(self, main, argv: list[str]):
        """One CLI's ``main(argv)`` as path "shell", its output appended to
        ``cli.log``; returns ``(main's result, seconds)``."""
        def run():
            with quiet("cli.log"):
                t0 = time.perf_counter()
                out = main(argv)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0
        return self.drive("shell", run)

    # 20b
    def shell_selfplay(self) -> str:
        """``tools.selfplay.main`` at 65,536 transitions, batch 4096, the
        random-legal policy: every row checked on the host
        (:func:`check_transitions`); the CSV read and written by the native
        and the numpy paths, byte-identical and equal; random play's game
        score from a longer rollout (batch 256, 256 steps an env)."""
        import shutil

        from gym2048_tpu_torch import native
        from gym2048_tpu_torch.data import TrainingData
        from gym2048_tpu_torch.tools import selfplay

        self.repo = os.getcwd()
        shutil.rmtree(SHELL_DIR, ignore_errors=True)
        os.makedirs(SHELL_DIR)
        os.chdir(SHELL_DIR)
        _, secs = self.shell_cli(selfplay.main, ["-o", "selfplay.csv", "-n", str(SELFPLAY_N),
                                                 "--batch", str(SELFPLAY_BATCH),
                                                 "--seed", str(SEED)])
        size = os.path.getsize("selfplay.csv")
        t0 = time.perf_counter()
        td = TrainingData()
        td.import_csv("selfplay.csv")
        read_native = time.perf_counter() - t0
        with native.unavailable():
            t0 = time.perf_counter()
            td_np = TrainingData()
            td_np.import_csv("selfplay.csv")
            read_numpy = time.perf_counter() - t0
        for get in ("get_x", "get_y_digit", "get_reward", "get_next_x", "get_done"):
            check(np.array_equal(getattr(td, get)(), getattr(td_np, get)()),
                  f"native and numpy reads differ in {get}")
        t0 = time.perf_counter()
        td.export_csv("native.csv")
        write_native = time.perf_counter() - t0
        with native.unavailable():
            t0 = time.perf_counter()
            td.export_csv("numpy.csv")
            write_numpy = time.perf_counter() - t0
        raw = open("selfplay.csv", "rb").read()
        check(open("native.csv", "rb").read() == raw and open("numpy.csv", "rb").read() == raw,
              "the native and numpy writers' CSV files differ")
        rows, dones = check_transitions(td, SELFPLAY_N // SELFPLAY_BATCH)
        check(rows == SELFPLAY_N, f"{rows} rows, not {SELFPLAY_N}")
        stats = self.drive("shell", lambda: selfplay.generate(
            SELFPLAY_N, batch=STATS_BATCH, seed=SEED, device=self.dev))
        steps = SELFPLAY_N // STATS_BATCH
        check_transitions(stats, steps)
        r = stats.get_reward().reshape(-1, steps)
        d = stats.get_done().reshape(-1, steps)
        games = []
        for env in range(STATS_BATCH):  # complete games: from a reset to a done
            ends = np.nonzero(d[env])[0]
            games += [r[env, a + 1:b + 1].sum() for a, b in zip(ends[:-1], ends[1:])]
            if len(ends):
                games.append(r[env, :ends[0] + 1].sum())
        mean = float(np.mean(games))
        check(600 < mean < 1600, f"random play's average game score {mean}")
        mb = size / 1e6
        return (f"{SELFPLAY_N} transitions (batch {SELFPLAY_BATCH}, {dones} dones) in "
                f"{secs:.3f} s through the CLI ({SELFPLAY_N / secs:.1f} transitions/s, the "
                f"CSV write included); every row legal, its reward the merge score, its next "
                f"board the move plus one 2 or 4, episodes contiguous; CSV {mb:.3f} MB, "
                f"native and numpy writers byte-identical: write {mb / write_native:.1f} / "
                f"{mb / write_numpy:.1f} MB/s, read {mb / read_native:.1f} / "
                f"{mb / read_numpy:.1f} MB/s (native / numpy); random play at batch "
                f"{STATS_BATCH}: {len(games)} complete games, average score {mean:.1f} "
                f"(random 2048: ~1,000)")

    # 20c
    def shell_bc(self) -> str:
        """``tools.pretrain_bc.main`` on 20b's CSV, 8x augmented, one epoch
        of ActorCritic(64, 4); the pickle in the flax layout that the JAX
        package's ``load_model`` and ``ActorCritic.apply`` read."""
        from gym2048_tpu_torch.data import TrainingData
        from gym2048_tpu_torch.tools import pretrain_bc
        from gym2048_tpu_torch.train import bc
        from gym2048_tpu_torch.utils.checkpoint import load_model

        with timed_methods(bc.BCTrainer, ("fit",)) as timer:
            _, secs = self.shell_cli(pretrain_bc.main, ["selfplay.csv", "--epochs", "1",
                                                        "--output", "bc",
                                                        "--seed", str(SEED)])
        fit_s = timer.seconds["fit"][0]
        variables, meta = load_model("bc.pkl")
        check(meta == {"filters": CNN_FILTERS, "residual_blocks": CNN_BLOCKS,
                       "model": "ActorCritic"}, f"bc.pkl meta {meta}")
        params = variables["params"]
        check(set(params) == {"_Trunk_0", "policy_head", "value_head"}
              and np.shape(params["_Trunk_0"]["Conv_0"]["kernel"]) == (3, 3, 16, CNN_FILTERS)
              and np.shape(params["policy_head"]["kernel"]) == (16 * CNN_FILTERS, 4)
              and set(variables["batch_stats"]["_Trunk_0"]) == set(
                  k for k in params["_Trunk_0"] if not k.startswith("Conv")),
              "bc.pkl is not in the flax layout")
        acc = self.shell_log_value(r"Epoch 1/1 — loss: ([\d.]+) — accuracy: ([\d.]+)", 2)
        samples = 8 * SELFPLAY_N
        td = TrainingData()
        td.import_csv("selfplay.csv")
        return (f"ActorCritic({CNN_FILTERS}, {CNN_BLOCKS}), one epoch over {samples} samples "
                f"(8x augmented), batch 256: accuracy {acc:.4f} (chance 0.25; a uniform legal "
                f"guess {legal_chance(td.get_x())[0]:.4f}: the labels are uniform legal moves, "
                f"so only legality is learnable), fit {fit_s:.2f} s "
                f"({samples / fit_s:.1f} samples/s), the CLI {secs:.2f} s; bc.pkl in the "
                f"flax layout")

    def shell_log_value(self, pattern: str, group: int = 1) -> float:
        """A number from the CLIs' ``cli.log``: ``group`` of the last line
        matching ``pattern``."""
        found = re.findall(pattern, open("cli.log").read())
        check(found, f"cli.log has no line matching {pattern!r}")
        hit = found[-1]
        return float(hit[group - 1] if isinstance(hit, tuple) else hit)

    # 20d
    def shell_selfplay_model(self) -> str:
        """``tools.selfplay.main --policy model`` with 20c's model, epsilon
        0.1, 65,536 transitions at batch 4096: its kept rows checked as in
        20b (illegal moves are dropped, so rows are not counted per env)."""
        from gym2048_tpu_torch.core import rules_np
        from gym2048_tpu_torch.data import TrainingData
        from gym2048_tpu_torch.tools import selfplay

        _, secs = self.shell_cli(selfplay.main, [
            "-o", "selfplay_bc.csv", "-n", str(SELFPLAY_N), "--batch", str(SELFPLAY_BATCH),
            "--policy", "model", "--model", "bc.pkl", "--epsilon", "0.1",
            "--seed", str(SEED)])
        td = TrainingData()
        td.import_csv("selfplay_bc.csv")
        x, a = td.get_x(), td.get_y_digit().reshape(-1)
        new, score, changed = rules_np.move_batch(x, a)
        check(bool(changed.all()), "an illegal row was kept")
        check(np.array_equal(td.get_reward().reshape(-1), score.astype(np.float64)),
              "a reward is not the merge score")
        check(bool(((td.get_next_x() - new) != 0).sum(axis=(1, 2)).max() == 1),
              "a next board is not the move plus one tile")
        kept = td.size()
        return (f"{SELFPLAY_N} transitions (batch {SELFPLAY_BATCH}, epsilon 0.1) in {secs:.3f} s "
                f"({SELFPLAY_N / secs:.1f} transitions/s through the CLI); {kept} legal rows "
                f"kept, {SELFPLAY_N - kept} illegal moves dropped, {int(td.get_done().sum())} "
                f"dones")

    # 20e
    def shell_ppo(self) -> str:
        """``tools.ppo.main --pretrained bc.pkl`` at the production shape
        (4096 envs x 128 steps, batch 16,384, bf16, the mask) for 2
        iterations with a checkpoint each; the last checkpoint restored
        into a fresh state equal to the run's state leaf for leaf
        (generator included); ``--resume`` to a third iteration."""
        from gym2048_tpu_torch.tools import ppo as ppo_cli
        from gym2048_tpu_torch.train import ppo
        from gym2048_tpu_torch.utils import checkpoint

        with timed_methods(ppo.PPO, ("train_iteration",)) as it_timer, \
                timed_methods(checkpoint.Checkpointer, ("save",)) as save_timer:
            state2, secs = self.shell_cli(ppo_cli.main, SHELL_PPO + [
                "--total-timesteps", str(2 * SHELL_PPO_ROLLOUT), "--pretrained", "bc.pkl"])
            check(state2.update_idx == 2, f"update_idx {state2.update_idx} after 2 iterations")
            ckpt = checkpoint.Checkpointer("checkpoints")
            check(ckpt.all_steps() == [1, 2], f"checkpoints {ckpt.all_steps()}")
            cfg = ppo.PPOConfig(total_timesteps=2 * SHELL_PPO_ROLLOUT, n_envs=4096, n_steps=128,
                                batch_size=16384, compute_dtype=torch.bfloat16,
                                mask_illegal=True, seed=SEED)
            fresh = ppo.PPO(cfg, device=self.dev).init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = ckpt.restore(like=fresh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            diffs = checkpoint_diffs(state2, restored)
            check(not diffs, f"the restored state differs from the saved one: {diffs}")
            state3, secs3 = self.shell_cli(ppo_cli.main, SHELL_PPO + [
                "--total-timesteps", str(3 * SHELL_PPO_ROLLOUT), "--resume"])
        check(state3.update_idx == 3 and ckpt.all_steps() == [1, 2, 3],
              f"--resume: update_idx {state3.update_idx}, checkpoints {ckpt.all_steps()}")
        lines = open("logs/shell.jsonl").read().splitlines()
        check(len(lines) == 3, f"logs/shell.jsonl has {len(lines)} lines, not 3")
        ret = [json.loads(x)["rollout/ep_rew_mean"] for x in lines]
        its = it_timer.seconds["train_iteration"]
        size = sum(p.stat().st_size for p in (ckpt.root / "3").iterdir()) / 1e6
        final = [f for f in os.listdir(".") if f.startswith("ppo_model_final_")]
        check(final, "no final model")
        self.final_model = max(final, key=os.path.getmtime)  # the resumed run's
        return (f"2 iterations from bc.pkl in {secs:.2f} s, --resume to a third in "
                f"{secs3:.2f} s; an iteration {', '.join(f'{x:.3f}' for x in its)} s "
                f"({SHELL_PPO_ROLLOUT / sorted(its)[1]:.1f} steps/s, the median); the "
                f"restored state equal to the run's leaf for leaf (weights, BatchNorm "
                f"statistics, Adam, count, envs, generator, update_idx); checkpoint "
                f"{size:.2f} MB: save {', '.join(f'{x:.3f}' for x in save_timer.seconds['save'])}"
                f" s, restore {restore_s:.3f} s; ep_rew_mean (rolling) "
                + ", ".join(f"{x:.1f}" for x in ret))

    # 20f
    def shell_evaluate(self) -> str:
        """``tools.evaluate.main`` of 20e's final model, the reference
        protocol (10 episodes, epsilon 0.1), on the card with TF32 off and
        on the CPU: ``scores_<label>.csv`` identical, or the first argmax
        flip reported with its margin (which must be roundoff); then
        ``--fast --mask-illegal`` at 512 episodes."""
        import csv as csvlib

        from gym2048_tpu_torch.tools import evaluate

        argv = [self.final_model, "--episodes", str(HOST_EVAL_EPISODES),
                "--epsilon", str(HOST_EVAL_EPSILON)]
        with tf32(False):
            _, card_s = self.shell_cli(evaluate.main, argv + ["--label", "card"])
        _, cpu_s = self.shell_cli(evaluate.main, argv + ["--label", "cpu", "--device", "cpu"])
        card, cpu = open("scores_card.csv").read(), open("scores_cpu.csv").read()
        rows = list(csvlib.DictReader(card.splitlines()))
        moves = sum(int(r["moves"]) for r in rows)
        if card == cpu:
            agree = "scores_card.csv and scores_cpu.csv identical"
        else:
            episode, move, margin = self.first_flip(rows, list(csvlib.DictReader(
                cpu.splitlines())))
            check(margin < FLIP_MARGIN_MAX, f"episode {episode} move {move}: the card's and the "
                  f"CPU's argmax differ by a margin of {margin}")
            agree = (f"the scores differ from episode {episode}: its move {move} flips the "
                     f"argmax on roundoff (top-2 margin {margin:.3g})")
        _, fast_s = self.shell_cli(evaluate.main, [
            self.final_model, "--episodes", str(FAST_EVAL_EPISODES), "--fast",
            "--mask-illegal", "--label", "fast", "--seed", str(SEED)])
        fast = list(csvlib.DictReader(open("scores_fast.csv").read().splitlines()))
        check(len(fast) == FAST_EVAL_EPISODES and all(r["illegal_moves"] == "0" for r in fast),
              "--fast --mask-illegal: an illegal move or a missing episode")
        fast_avg = np.mean([float(r["total_reward"]) for r in fast])
        card_avg = np.mean([float(r["total_reward"]) for r in rows])
        return (f"host protocol, {HOST_EVAL_EPISODES} episodes, epsilon {HOST_EVAL_EPSILON}: "
                f"average {card_avg:.1f}, {moves} moves; card (TF32 off) {card_s:.2f} s "
                f"({1e3 * card_s / moves:.3f} ms a move), CPU {cpu_s:.2f} s "
                f"({1e3 * cpu_s / moves:.3f} ms a move); {agree}; --fast --mask-illegal, "
                f"{FAST_EVAL_EPISODES} episodes: average {fast_avg:.1f}, "
                f"{FAST_EVAL_EPISODES / fast_s:.1f} episodes/s ({fast_s:.2f} s)")

    def first_flip(self, card_rows, cpu_rows) -> tuple[int, int, float]:
        """The first episode whose scores differ between the card and the
        CPU, replayed under the protocol with both models: ``(episode, move,
        the CPU's top-2 probability margin)`` at the first move whose greedy
        choice differs."""
        import random

        from gym2048_tpu_torch import interop
        from gym2048_tpu_torch.env import adapter
        from gym2048_tpu_torch.train import eval as ev
        from gym2048_tpu_torch.utils.checkpoint import load_model

        episode = next(i for i, (a, b) in enumerate(zip(card_rows, cpu_rows)) if a != b)
        variables, _ = load_model(self.final_model)
        on_card = ev.make_predict_fn(interop.resnet_from_variables(variables, device=self.dev))
        on_cpu = ev.make_predict_fn(interop.resnet_from_variables(variables, device="cpu"))
        env = adapter.Game2048Env()
        env.set_illegal_move_reward(-1.0)
        random.seed(123 + episode)
        obs, _ = env.reset(seed=456 + episode)
        with tf32(False):
            for move in range(ev.MOVE_CAP + 1):
                p_card, p_cpu = on_card(obs), on_cpu(obs)
                if np.argmax(p_card) != np.argmax(p_cpu):
                    top = np.sort(p_cpu)
                    return episode, move, float(top[-1] - top[-2])
                action = ev.choose_action(lambda _: p_cpu, obs, HOST_EVAL_EPSILON)
                obs, _, terminated, _, _ = env.step(action)
                if terminated:
                    break
        raise RuntimeError(f"check failed: episode {episode} differs, but no argmax flips")

    # 20g
    def shell_train(self) -> str:
        """``tools.train.main`` on 20b's CSV: Game2048Model(64, 8) (the
        CLI's defaults), one epoch, ``--fast-eval`` before and after."""
        from gym2048_tpu_torch.data import TrainingData
        from gym2048_tpu_torch.tools import train
        from gym2048_tpu_torch.train import bc
        from gym2048_tpu_torch.utils.checkpoint import load_model

        np.random.seed(SEED)  # TrainingData.shuffle draws from numpy's global generator
        with timed_methods(bc.BCTrainer, ("fit",)) as timer:
            val, secs = self.shell_cli(train.main, ["selfplay.csv", "--epochs", "1",
                                                    "--fast-eval", "--seed", str(SEED)])
        n_train = int(self.shell_log_value(r"(\d+) training / (\d+) validation samples"))
        fit_s = timer.seconds["fit"][0]
        variables, meta = load_model("model.pkl")
        check(meta["model"] == "Game2048Model" and "trunk" in variables["params"]
              and sum(k.startswith("ResidualBlock_") for k in variables["params"]["trunk"]) == 8,
              "model.pkl is not Game2048Model(64, 8) in the flax layout")
        # the labels are uniform legal moves: one epoch must beat a uniform guess
        # over the four moves (loss ln 4), and no more than legality is learnable
        check(val["loss"] < math.log(4) and 0.2 <= val["accuracy"] <= 1.0,
              f"validation loss {val['loss']}, accuracy {val['accuracy']}")
        td = TrainingData()
        td.import_csv("selfplay.csv")
        best_acc, best_loss = legal_chance(td.get_x())
        return (f"Game2048Model(64, 8), {n_train} training samples (80%, 8x augmented, "
                f"deduplicated), one epoch at batch 128: fit {fit_s:.2f} s "
                f"({n_train / fit_s:.1f} samples/s); validation loss {val['loss']:.4f} "
                f"(ln 4 = 1.3863, the legal-uniform best {best_loss:.4f}), accuracy "
                f"{val['accuracy']:.4f} (chance 0.25, the legal-uniform best "
                f"{best_acc:.4f}); the CLI {secs:.2f} s with "
                f"--fast-eval of 10 episodes before and after")

    # 18
    def ops_on_card(self) -> str:
        """Every ``ops`` function on CUDA tensors against its CPU result:
        exact for the encoders and the augmentation, within 1e-6 of the
        output's largest magnitude for the returns."""
        from gym2048_tpu_torch.models import resnet
        from gym2048_tpu_torch.ops import augment, obs, returns

        rng = np.random.default_rng(SEED)
        b = torch.as_tensor(random_boards(rng, 4096, 17, 0.3))
        nb = torch.as_tensor(random_boards(rng, 4096, 17, 0.3))
        a = torch.as_tensor(rng.integers(0, 4, 4096))
        r = torch.as_tensor(rng.integers(0, 3000, (256, 64)).astype(np.float32))
        v = torch.as_tensor(rng.normal(size=(256, 64)).astype(np.float32) * 100)
        d = torch.as_tensor(rng.random((256, 64)) < 0.05)
        exact = {
            "env_stack": lambda x: obs.env_stack(x[0]),
            "dataset_stack": lambda x: obs.dataset_stack(x[0]),
            "unstack_env": lambda x: obs.unstack_env(obs.env_stack(x[0])),
            "dataset_to_env": lambda x: obs.dataset_to_env(obs.dataset_stack(x[0])),
            "hflip_boards": lambda x: augment.hflip_boards(x[0]),
            "hflip_actions": lambda x: augment.hflip_actions(x[2]),
            "rotate_boards": lambda x: augment.rotate_boards(x[0], 3),
            "rotate_actions": lambda x: augment.rotate_actions(x[2], 3),
            "augment8": lambda x: augment.augment8(x[0], x[2], x[1]),
            "boards_to_model_input": lambda x: resnet.boards_to_model_input(x[0]),
        }
        close = {
            "log2_rewards": lambda x: (returns.log2_rewards(x[3]),),
            "discounted_returns": lambda x: (returns.discounted_returns(x[3][:, 0], x[5][:, 0]),),
            "gae": lambda x: returns.gae(x[3], x[4], x[5], x[4][0]),
            "normalize": lambda x: (returns.normalize(x[3]),),
        }
        cpu = (b, nb, a, r, v, d)
        gpu = tuple(x.to(self.dev) for x in cpu)

        def outs(fn, x):
            out = fn(x)
            return out if isinstance(out, tuple) else (out,)

        for name, fn in exact.items():
            for g, c in zip(outs(fn, gpu), outs(fn, cpu)):
                check(g.device.type == "cuda" and torch.equal(g.cpu(), c),
                      f"ops {name} on the card differs from the CPU")
        worst = 0.0
        for name, fn in close.items():
            for g, c in zip(outs(fn, gpu), outs(fn, cpu)):
                check(g.device.type == "cuda", f"ops {name} left the card")
                # relative to the output's largest magnitude: normalize's
                # moments are sums in another order, and its values near 0
                rel = ((g.cpu().double() - c.double()).abs().max()
                       / c.double().abs().max().clamp(min=1e-30)).item()
                worst = max(worst, rel)
                check(rel <= 1e-6, f"ops {name}: relative error {rel}")
        return (f"{', '.join(exact)}: equal to the CPU; {', '.join(close)}: within "
                f"{worst:.3g} of the largest magnitude (limit 1e-6)")

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
    smoke.run("2b", "registers", smoke.registers)
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
    smoke.run("17a", "td small path", smoke.td_small_path)
    smoke.run("17b", "td small gather", smoke.td_small_gather)
    smoke.run("17c", "td small kernel vs plain", smoke.td_small_replay)
    smoke.run("17d", "td small throughput", smoke.td_small_throughput)
    smoke.run("17e", "td small learning", smoke.td_small_learning)
    smoke.run("17f", "td small play", smoke.td_small_play)
    smoke.run("18", "ops", smoke.ops_on_card)
    smoke.run("19a", "cnn forward", smoke.cnn_forward)
    smoke.run("19b", "ppo throughput", smoke.ppo_throughput)
    smoke.run("19c", "ppo learning", smoke.ppo_learning)
    smoke.run("19d", "bc", smoke.bc_epoch)
    smoke.run("19e", "ppo evaluation", smoke.ppo_evaluation)
    try:
        smoke.run("20a", "shell engine", smoke.shell_engine)
        smoke.run("20b", "shell selfplay", smoke.shell_selfplay)
        smoke.run("20c", "shell pretrain_bc", smoke.shell_bc)
        smoke.run("20d", "shell selfplay model", smoke.shell_selfplay_model)
        smoke.run("20e", "shell ppo", smoke.shell_ppo)
        smoke.run("20f", "shell evaluate", smoke.shell_evaluate)
        smoke.run("20g", "shell train", smoke.shell_train)
    finally:
        if getattr(smoke, "repo", None):
            os.chdir(smoke.repo)
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


def gather_ab(sources: list[str], rounds: int = GATHER_AB_ROUNDS) -> int:
    """Compare versions of ``table_gather.cu`` in one process, on one card.

    Each source is built into a library of its own (one ``nvcc`` each,
    started together) and held bit for bit against the plain version on
    the lookup streams of the paths: the agent's depth-2 leaves, the TD
    step's afterstates after the first flagship chunk and after the 50
    chunks of phase 15f, and a uniform stream of 1,024 indices (the
    launch). Then ``rounds`` rounds time every source on every stream warm
    (``graph_ms``), cold (``cold_graph_ms``) and alone (``alone_ms``), the
    sources in turn, forward in even rounds and backward in odd ones. The
    first source is the baseline: each other one is reported with the
    ratio of its median to the baseline's and the rounds in which it was
    faster. Builds the streams through phases 1, 2, 8a, 11, 15a and 15f."""
    from pathlib import Path

    from gym2048_tpu_torch import _build, _sass

    smoke = Smoke()
    for num, name, fn in (("1", "device", smoke.device), ("2", "build", smoke.build),
                          ("8a", "main path", smoke.main_path),
                          ("11", "gather_values", smoke.gather_values),
                          ("15a", "td path", smoke.td_path),
                          ("15f", "td learning", smoke.td_learning)):
        smoke.run(num, name, fn)
    out_dir = _build.BUILD / "gather_ab"
    paths = _build.build_all(libraries={
        str(i): (Path(src).resolve(), out_dir / f"libgather_ab{i}.so")
        for i, src in enumerate(sources)})
    libs = [_build.load(path, "table_gather") for path in paths.values()]
    for src, path in zip(sources, paths.values()):
        listing = subprocess.run([_sass.find_cuobjdump(), "-res-usage", str(path)],
                                 capture_output=True, text=True, check=True).stdout
        usage = resource_usage(listing)
        print(f"source {src}: " + ", ".join(
            f"{k} {u['REG']} registers, {u['STACK']} B stack" for k, u in sorted(usage.items())),
            flush=True)
    gen = torch.Generator(device=smoke.dev).manual_seed(SEED)
    uniform = torch.randint(0, smoke.net.table_size, (1 << 10,), generator=gen,
                            device=smoke.dev, dtype=torch.int32)
    streams = {
        "uniform 1024": (smoke.table, uniform),
        "agent": (smoke.table,
                  smoke.net.indices_batch(leaf_afterstates(smoke.leaf_roots)).reshape(-1)),
        "TD": (smoke.td_state["table"], smoke.td_stream(smoke.td_trainer._net, smoke.td_state)[0]),
        "late TD": smoke.late_stream,
    }
    outs = {name: torch.empty(idx.shape, dtype=torch.float32, device=smoke.dev)
            for name, (_, idx) in streams.items()}

    def call(lib, name):
        table, idx = streams[name]
        err = lib.gym_gather_values(table.data_ptr(), idx.data_ptr(), outs[name].data_ptr(),
                                    idx.numel(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"launch failed with error {err}")

    for i, lib in enumerate(libs):
        for name, (table, idx) in streams.items():
            outs[name].fill_(float("nan"))
            call(lib, name)
            want = torch.take(table, idx.long())
            check(torch.equal(outs[name].view(torch.int32), want.view(torch.int32)),
                  f"source {sources[i]} differs from plain on the {name} stream")
    print(f"every source bit-exact on {', '.join(streams)}", flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=smoke.dev)
    modes = {"warm": lambda fn: graph_ms(fn, 20),
             "cold": lambda fn: cold_graph_ms(fn, lambda: flush.fill_(1.0), 20),
             "alone": alone_ms}
    times = {(i, name, mode): [] for i in range(len(libs)) for name in streams for mode in modes}
    for r in range(rounds):
        order = range(len(libs)) if r % 2 == 0 else reversed(range(len(libs)))
        for i in order:
            for name in streams:
                for mode, measure in modes.items():
                    times[i, name, mode].append(
                        1e3 * measure(lambda: call(libs[i], name)))
    print(f"us per call, {rounds} rounds; per source: median [each round]; against "
          f"source 0: ratio of medians, rounds faster")
    for name in streams:
        for mode in modes:
            base = times[0, name, mode]
            parts = []
            for i in range(len(libs)):
                t = times[i, name, mode]
                text = f"{i}: {np.median(t):.3f} [{' '.join(f'{x:.3f}' for x in t)}]"
                if i:
                    wins = sum(a < b for a, b in zip(t, base))
                    text += f" {np.median(t) / np.median(base):.4f} {wins}/{rounds}"
                parts.append(text)
            print(f"{name} {mode}: " + "; ".join(parts), flush=True)
    print(smoke.smi)
    return 0


def parse_args(argv: list[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gather-ab", nargs="+", metavar="SOURCE",
                        help="instead of the phases, compare these versions of "
                             "table_gather.cu on the lookup streams (the first is the "
                             "baseline)")
    parser.add_argument("--rounds", type=int, default=GATHER_AB_ROUNDS,
                        help="rounds of --gather-ab")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args(sys.argv[1:])
    if args.gather_ab and torch.cuda.is_available():
        sys.exit(gather_ab(args.gather_ab, args.rounds))
    sys.exit(main())
