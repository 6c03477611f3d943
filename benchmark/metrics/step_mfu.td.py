"""step_mfu.td: the whole TD window's least time on the card (bytes, counted from the TD
entry's sampled steps) over its measured time (%)."""

from benchmark.layer_metrics import td_step_mfu


def read(ctx):
    return td_step_mfu(ctx)
