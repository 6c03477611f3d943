"""optimizer_host_ms.ppo: host self time of the program's span ``ppo.optimizer`` a PPO
iteration (ms): the SGD step's optimiser: global-norm clip and Adam."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.optimizer")
