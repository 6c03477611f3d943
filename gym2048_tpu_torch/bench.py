"""Headline benchmark of the port (counterpart of the repository's root
``bench.py``): six end-to-end rates on one card, printed as ONE JSON line
with root ``bench.py``'s keys, so that two lines compare key for key.

Run it as

    python -m gym2048_tpu_torch.bench [--device cuda|cpu]

On the card (the default) it measures all six rates. With ``--device cpu``
it measures only the plain env, as root ``bench.py`` does off the TPU, and
prints ``null`` for the others. There is no fallback: without a card and
without ``--device cpu`` it fails.

What the keys measure here:

* ``xla_steps_per_s`` (and its spread, ``xla_batch``, ``scan_len``) — the
  plain env: ``BATCH`` boards of ``env/batched.py`` (the legal mask, then
  the step with auto-reset) under a uniform random-legal policy, ``T_LARGE``
  steps a run in a Python loop of PyTorch operators. In JAX the loop is one
  compiled program; here the host launches every step, which is the env
  the port's learners call. ``xla_scaling_check_ratio`` is the per-step time
  at ``T_SMALL`` over that at ``T_LARGE``; it must lie in
  ``[RATIO_MIN, RATIO_MAX]`` (a ratio near 8 or below 1 means the clock did
  not time the device's work).
* ``pallas_fused_steps_per_s`` (and its spread, ``pallas_batch``) — the
  fused rollout kernel (``csrc/fused_step.cu`` through
  ``core/fused_step.fused_rollout``): ``PALLAS_BATCH`` boards stepped
  ``T_LARGE`` times in one launch. It is the headline ``value`` on the card.
* ``td_train_steps_per_s`` — the small n-tuple net's TD learner at 8192 envs
  x 64 steps with the split lookup (root ``bench.py::bench_td``);
  ``td_big_4x6_tc_steps_per_s`` — the 4x6 TC learner at 8192 x 16
  (``bench_td_big``). Every lookup is the gather kernel
  (``csrc/table_gather.cu``).
* ``ppo_steps_per_s`` — PPO at the production shape (4096 envs x 128 steps,
  batch 16,384, bf16, the sharded shuffle); ``..._reference_config`` at the
  reference's defaults (8 envs x 2048 steps, batch 256, f32).
* ``device`` — the card's name and power limit as ``nvidia-smi`` gives them.

Statistics are root ``bench.py``'s: the median of ``SAMPLES`` runs and the
[min, max] spread for the two env rates (after a warm-up), the best of 3
chunks or of 2 iterations after a warm-up for the learners; each timed run
ends by reading a value of its result on the host. The exit code is 1 when
the ratio is outside its bounds or a learner's rate is under its floor.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from gym2048_tpu_torch.core import fused_step
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.train import ppo, td

BATCH = 65536
T_SMALL = 128
T_LARGE = 1024
# BASELINE.md's north-star target of 1e8 env steps/s on one chip: a target,
# not a measurement on any device
TARGET = 1.0e8
# Root bench.py's linearity guard on the plain env's per-step time at
# T_SMALL over T_LARGE (see the module docstring).
RATIO_MIN = 0.8
RATIO_MAX = 3.0
PALLAS_BATCH = 1048576
PALLAS_BLOCK = 8192
SAMPLES = 5  # timed runs of each env rate; the median and [min, max] are reported
ROLLOUT_SEED = 5  # the fused rollout's Philox key, as root bench.py's

# Sanity floors (env steps/s): a quarter of the lowest rate that four runs
# of this bench measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (PERF.md §6): TD 2,934,524, TD 4x6 2,070,091, PPO 296,181 and 1,353. A rate
# below its floor means a learner's loop broke, not that the host was slow
# (rates move up to ~2x between machines). Root bench.py's floors are TPU
# numbers and are not used.
PPO_PROD_FLOOR = 74_045
PPO_REF_FLOOR = 338
TD_FLOOR = 733_631
TD_BIG_FLOOR = 517_522

AUTO_RESET = batched.EnvConfig(auto_reset=True)


def random_legal_step(state: batched.EnvState, generator: torch.Generator,
                      config: batched.EnvConfig = AUTO_RESET):
    """One step of every board under the uniform random-legal policy (the
    counterpart of ``jax.random.categorical`` over the legal mask): the
    legal action with the largest uniform draw. Returns ``(state, ts)``.
    The legal mask and the step share one ``move_products`` (``legal_actions``
    and ``step`` would each compute it; XLA computes it once in JAX's
    compiled loop)."""
    products = batched.move_products(state)
    noise = torch.rand(products[2].shape, generator=generator, device=state.board.device)
    action = torch.where(products[2], noise, -1.0).argmax(dim=1)
    return batched.step_with_products(state, action, products, config, generator=generator)


def rollout(state: batched.EnvState, length: int, generator: torch.Generator):
    """``length`` random-legal steps -> ``(state, checksum)``: the score sum
    plus the board sum, a device scalar whose host read ends the run."""
    for _ in range(length):
        state, _ = random_legal_step(state, generator)
    return state, state.score.sum() + state.board.sum(dtype=torch.int32)


def timed_runs(fn, repeats: int) -> list[float]:
    """Sorted seconds of ``repeats`` calls of ``fn``, each ending with its
    own host read."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def bench_xla(device: torch.device) -> tuple[float, list, float]:
    """The plain env: (median steps/s, [lo, hi] spread, ratio)."""
    gen = torch.Generator(device=device).manual_seed(0)
    state = batched.reset(gen, BATCH, device=device)

    def run(length):
        nonlocal state
        state, checksum = rollout(state, length, gen)
        float(checksum)

    run(T_SMALL)
    run(T_LARGE)
    ts_small = timed_runs(lambda: run(T_SMALL), 3)
    ts_large = timed_runs(lambda: run(T_LARGE), SAMPLES)
    ratio = (ts_small[0] / T_SMALL) / max(ts_large[0] / T_LARGE, 1e-12)
    med = ts_large[len(ts_large) // 2]
    spread = [BATCH * T_LARGE / ts_large[-1], BATCH * T_LARGE / ts_large[0]]
    return BATCH * T_LARGE / med, spread, ratio


def bench_pallas(device: torch.device) -> tuple[float, list]:
    """The fused rollout kernel: (median steps/s, [lo, hi] spread over
    ``SAMPLES`` runs after a warm-up)."""
    boards = fused_step.to_cell_major(
        torch.zeros((PALLAS_BATCH, 4, 4), dtype=torch.int8, device=device))

    def run():
        out = fused_step.fused_rollout(boards, ROLLOUT_SEED, T_LARGE, PALLAS_BLOCK)
        float(out[1].sum())

    run()
    times = timed_runs(run, SAMPLES)
    med = times[len(times) // 2]
    spread = [PALLAS_BATCH * T_LARGE / times[-1], PALLAS_BATCH * T_LARGE / times[0]]
    return PALLAS_BATCH * T_LARGE / med, spread


def _td_rate(cfg: td.TDConfig, alpha: float, device: torch.device) -> float:
    """Steps/s of the best of 3 chunks after a warm-up chunk."""
    tr = td.TDTrainer(cfg, device=device)
    state = tr.init_state()

    def run():
        nonlocal state
        state, m = tr.train_chunk(state, alpha)
        float(m["episodes"])

    run()
    return cfg.n_envs * cfg.chunk_steps / timed_runs(run, 3)[0]


def bench_td(device: torch.device) -> float:
    """The small net's TD learner (the split lookup, the quality default)."""
    b, steps = 8192, 64
    cfg = td.TDConfig(total_steps=b * steps, n_envs=b, chunk_steps=steps,
                      update_impl="mxu", value_impl="mxu")
    return _td_rate(cfg, 0.1, device)


def bench_td_big(device: torch.device) -> float:
    """The 4x6 TC learner (the flagship's network, unstaged)."""
    b, steps = 8192, 16
    cfg = td.TDConfig(total_steps=b * steps, n_envs=b, chunk_steps=steps, arch="4x6",
                      tc=True, alpha=1.0, alpha_final=1.0, init_value=0.0)
    return _td_rate(cfg, 1.0, device)


def bench_ppo(reference_shape: bool, device: torch.device) -> float:
    """PPO env steps/s through one whole ``train_iteration`` (rollout and
    update): the best of 2 after a warm-up, each read by its loss.
    ``reference_shape`` times the reference's defaults; otherwise the
    production shape (4096 x 128, batch 16,384, bf16, the sharded shuffle)."""
    if reference_shape:
        cfg = ppo.PPOConfig(total_timesteps=10**9)
    else:
        cfg = ppo.PPOConfig(total_timesteps=10**9, n_envs=4096, n_steps=128,
                            batch_size=16384, compute_dtype=torch.bfloat16,
                            shuffle_mode="sharded")
    trainer = ppo.PPO(cfg, device=device)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))

    def run():
        nonlocal state
        state, metrics = trainer.train_iteration(state)
        float(metrics["loss"])

    run()
    return cfg.rollout_size / timed_runs(run, 2)[0]


def device_name(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(index)], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _round(x):
    return round(x) if x else None


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="The port's headline benchmark: one JSON line.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the card (default) or the CPU, which measures the plain env only")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: CUDA is not available; pass --device cpu for the plain env on the CPU",
              file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    xla_rate, xla_spread, ratio = bench_xla(device)
    pallas_rate, pallas_spread = bench_pallas(device) if on_card else (None, None)
    rates = {
        "td_rate": bench_td(device) if on_card else None,
        "td_big_rate": bench_td_big(device) if on_card else None,
        "ppo_prod_rate": bench_ppo(False, device) if on_card else None,
        "ppo_ref_rate": bench_ppo(True, device) if on_card else None,
    }
    headline = pallas_rate if pallas_rate else xla_rate
    ratio_ok = RATIO_MIN <= ratio <= RATIO_MAX
    print(json.dumps({
        "metric": "batched_env_steps_per_s_1chip",
        "value": round(headline),
        "unit": "env_steps/s",
        "vs_baseline": round(headline / TARGET, 3),
        "detail": {
            "pallas_fused_steps_per_s": _round(pallas_rate),
            "pallas_spread_steps_per_s": (
                [round(v) for v in pallas_spread] if pallas_spread else None),
            "pallas_batch": PALLAS_BATCH,
            "xla_steps_per_s": round(xla_rate),
            "xla_spread_steps_per_s": [round(v) for v in xla_spread],
            "xla_batch": BATCH,
            "timing_samples": SAMPLES,
            "scan_len": T_LARGE,
            "td_train_steps_per_s": _round(rates["td_rate"]),
            "td_big_4x6_tc_steps_per_s": _round(rates["td_big_rate"]),
            "ppo_steps_per_s": _round(rates["ppo_prod_rate"]),
            "ppo_steps_per_s_reference_config": _round(rates["ppo_ref_rate"]),
            "xla_scaling_check_ratio": round(ratio, 3),
            "scaling_check_ok": ratio_ok,
            "device": device_name(device),
        },
    }), flush=True)
    if not ratio_ok:
        print(f"FAIL: scaling ratio {ratio:.3f} outside [{RATIO_MIN}, {RATIO_MAX}]: the "
              f"timing is not measuring the device's work", file=sys.stderr)
        return 1
    for rate, key, floor in ((rates["td_rate"], "td_train_steps_per_s", TD_FLOOR),
                             (rates["td_big_rate"], "td_big_4x6_tc_steps_per_s", TD_BIG_FLOOR),
                             (rates["ppo_prod_rate"], "ppo_steps_per_s", PPO_PROD_FLOOR),
                             (rates["ppo_ref_rate"], "ppo_steps_per_s_reference_config",
                              PPO_REF_FLOOR)):
        if rate is not None and rate < floor:
            print(f"FAIL: {key} {rate:.0f} below its sanity floor {floor}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
