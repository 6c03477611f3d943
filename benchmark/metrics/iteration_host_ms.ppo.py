"""iteration_host_ms.ppo: host self time of the program's span ``ppo.iteration`` a PPO
iteration (ms): the iteration's own host work: rewards, shuffles, loops, episode
statistics."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.iteration")
