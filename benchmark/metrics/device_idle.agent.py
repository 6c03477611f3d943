"""device_idle.agent: share of the traced agent window with no operation on the card (%)."""

from benchmark.layer_metrics import device_idle


def read(ctx):
    return device_idle(ctx)
