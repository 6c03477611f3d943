"""backward_host_ms.ppo: host self time of the program's span ``ppo.backward`` a PPO
iteration (ms): the SGD step's backward."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.backward")
