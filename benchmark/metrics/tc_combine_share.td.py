"""tc_combine_share.td: the device time of the operations launched inside the program's span
``td.combine`` (train/td.py::TDTrainer._combine: the delayed-TC combine, models/ntuple.py's
_tc_combine, and the zeroing of the pending sums) as a share of the window's busy time (%)."""

from benchmark.layer_metrics import span_device_share


def read(ctx):
    return span_device_share(ctx, "td.combine")
