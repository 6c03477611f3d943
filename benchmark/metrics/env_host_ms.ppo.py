"""env_host_ms.ppo: host self time of the program's span ``ppo.env`` a PPO iteration (ms):
the rollout's env step: move_products, step_with_products, the trajectory writes."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.env")
