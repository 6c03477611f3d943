"""policy_host_ms.ppo: host self time of the program's span ``ppo.policy`` a PPO iteration
(ms). On the card: the last value forward after the rollout (a rollout step's policy runs
inside its graph replay); eagerly also each step's forward, mask, Gumbel-max sampling and
logprob."""

from benchmark.program_spans import ppo_host_ms


def read(ctx):
    return ppo_host_ms("ppo.policy")
