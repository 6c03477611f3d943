"""kernels_per_move.agent: device operations a lockstep move of play_policy (agents/expectimax.py)."""

from benchmark.layer_metrics import ops_per_step


def read(ctx):
    return ops_per_step(ctx)
