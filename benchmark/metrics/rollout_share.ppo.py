"""rollout_share.ppo: host time inside PPO._collect_rollout as a share of the window (%)."""

from benchmark.layer_metrics import span_host_share


def read(ctx):
    return span_host_share(ctx, "collect_rollout")
