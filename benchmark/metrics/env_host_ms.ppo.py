"""env_host_ms.ppo: host self time of the program's span ``ppo.env`` a PPO iteration (ms): a
rollout step. On the card: the step's two draws into the rollout holder's buffers and its CUDA
graph replay; eagerly (off the card, data parallel, a holder's warm-ups): the draws,
move_products, step_with_products and the trajectory writes around the step's policy span."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.env")
