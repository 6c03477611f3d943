"""step_mfu.agent: the whole agent window's least time on the card (bytes) over its measured time (%)."""

from benchmark.layer_metrics import agent_step_mfu


def read(ctx):
    return agent_step_mfu(ctx)
