"""tc_combine_share.td: the TC combine's (_tc_combine through train/td.py) share of the device time (%)."""

from benchmark.layer_metrics import span_device_share


def read(ctx):
    return span_device_share(ctx, "tc_combine")
