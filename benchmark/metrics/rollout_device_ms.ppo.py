"""rollout_device_ms.ppo: device time a PPO iteration (ms) of the operations launched inside
the program's spans ``ppo.env`` and ``ppo.policy``, each once: every rollout step (on the card
its two draws and the kernels of its CUDA graph replay: the moves, the policy forward, the
mask, Gumbel-max, the env step and the trajectory writes) and the last value forward. None
without a device trace or without those spans."""

from benchmark.layer_metrics import span_device


def read(ctx):
    return span_device(ctx, ("ppo.env", "ppo.policy"), 1e3)
