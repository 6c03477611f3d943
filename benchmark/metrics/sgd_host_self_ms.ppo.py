"""sgd_host_self_ms.ppo: host self time of the program's span ``ppo.sgd`` a PPO iteration (ms):
the SGD steps that run on static buffers, each the copies of its minibatch in, the learning
rate's write and the CUDA graph replay of the forward, loss, backward, clip and Adam, and the
copy of its metrics out. None where the program has no such span."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.sgd")
