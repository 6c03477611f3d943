"""gae_host_ms.ppo: host self time of the program's span ``ppo.gae`` a PPO iteration (ms):
the GAE loop over the rollout's steps."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.gae")
