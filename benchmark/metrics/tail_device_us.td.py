"""tail_device_us.td: device time a TD step (us) of the operations launched inside the
program's span ``td.tail``: the copies of the greedy search's results into the step tail's
buffers and the kernels of the tail's CUDA graph replay (the TD error, delayed TC's
scatter-accumulate, the bookkeeping, spawn, the carousel and the reset). None without a device
trace or without the span (the program opens it only where the tail captures a graph)."""

from benchmark.layer_metrics import span_device


def read(ctx):
    return span_device(ctx, ("td.tail",), 1e6)
