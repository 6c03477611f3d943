"""policy_host_ms.ppo: host self time of the program's span ``ppo.policy`` a PPO iteration
(ms): the rollout's policy: forward, mask, Gumbel-max sampling, logprob; the last value
forward."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.policy")
