"""forward_host_ms.ppo: host self time of the program's span ``ppo.forward`` a PPO iteration
(ms): the SGD step's forward: model, legal mask, loss terms, loss sum."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.forward")
