#!/usr/bin/env python3
"""Run the reduced-scale PPO learning gate over several seeds, on the CPU.

The gate is ``tests/test_models_ppo.py::TestPPOLearningGate`` (JAX) and
``tests/test_torch_ppo.py::TestPPOLearningGate`` (the port): 8 iterations
of 128 envs x 64 steps, batch 512, 4 epochs, 16 filters, 1 block; it passes
when the mean ep-return of the first two iterations is below 60 and that of
the last two at least 65 and 1.25 times the first. The port's test takes
``GATE``, ``SEED`` and the thresholds from this module. The tests run one
seed (7); this script shows how the gate fares on others, for the port or,
with ``--jax``, for the JAX package:

    python scripts/ppo_gate_seeds.py 7 0 1 2 3 4
    JAX_PLATFORMS=cpu python scripts/ppo_gate_seeds.py --jax 7 0 1 2 3 4

One line per seed: the eight ep-returns, the two means and PASS or FAIL.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GATE = dict(total_timesteps=8 * 128 * 64, n_envs=128, n_steps=64, batch_size=512,
            n_epochs=4, filters=16, residual_blocks=1)
SEED = 7
FIRST_MAX, LAST_MIN, GAIN_MIN = 60.0, 65.0, 1.25


def gate_means(rets: list[float]) -> tuple[float, float]:
    """The mean ep-return of the first two and of the last two iterations."""
    return (rets[0] + rets[1]) / 2, (rets[-2] + rets[-1]) / 2


def gate_passes(rets: list[float]) -> bool:
    first2, last2 = gate_means(rets)
    return first2 < FIRST_MAX and last2 >= LAST_MIN and last2 >= GAIN_MIN * first2


def port_returns(seed: int) -> list[float]:
    import torch

    from gym2048_tpu_torch.train import ppo

    torch.set_num_threads(1)
    trainer = ppo.PPO(ppo.PPOConfig(**GATE, seed=seed), device="cpu")
    state = trainer.init_state()
    rets = []
    for _ in range(trainer.cfg.n_updates):
        state, metrics = trainer.train_iteration(state)
        rets.append(float(metrics["ep_return_mean"]))
    return rets


def jax_returns(seed: int) -> list[float]:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from gym2048_tpu.train import PPO, PPOConfig

    trainer = PPO(PPOConfig(**GATE, seed=seed))
    state = trainer.init_state()
    rets = []
    for _ in range(trainer.cfg.n_updates):
        state, metrics = trainer.train_iteration(state)
        rets.append(float(np.asarray(metrics["ep_return_mean"])))
    return rets


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("seeds", type=int, nargs="+")
    parser.add_argument("--jax", action="store_true", help="run the JAX package's gate")
    args = parser.parse_args(argv)
    run = jax_returns if args.jax else port_returns
    passed = 0
    for seed in args.seeds:
        rets = run(seed)
        first2, last2 = gate_means(rets)
        ok = gate_passes(rets)
        passed += ok
        print(f"seed {seed}: {' '.join(f'{r:.1f}' for r in rets)}; first two {first2:.2f}, "
              f"last two {last2:.2f}: {'PASS' if ok else 'FAIL'}", flush=True)
    print(f"{passed} of {len(args.seeds)} seeds pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
