"""step_mfu.ppo: the model's forward and backward FLOPs over the window's time, against the dense peak of the cell's dtype (%)."""

from benchmark.layer_metrics import ppo_step_mfu


def read(ctx):
    return ppo_step_mfu(ctx)
