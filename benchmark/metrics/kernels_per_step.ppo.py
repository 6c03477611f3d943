"""kernels_per_step.ppo: device operations an env step of the PPO iteration (train/ppo.py)."""

from benchmark.layer_metrics import ops_per_step


def read(ctx):
    return ops_per_step(ctx)
