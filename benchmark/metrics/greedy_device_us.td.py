"""greedy_device_us.td: device time a TD step (us) of the operations launched inside the
program's span ``td.greedy`` (with ``td.lookup`` inside it): the greedy search's move_all,
lookup (indices, the gather kernel, the sum over symmetries), argmax and gathers, eager or
replayed. None without a device trace or without the span."""

from benchmark.layer_metrics import span_device


def read(ctx):
    return span_device(ctx, ("td.greedy",), 1e6)
