"""sgd_device_ms.ppo: device time a PPO iteration (ms) of the operations launched inside the
program's span ``ppo.sgd``: every SGD step that runs on static buffers (the minibatch's copies
in, the step's two scalars, the kernels of its CUDA graph replay: forward, loss, backward, clip
and Adam, and the metrics' copy out). None without a device trace or without the span (the
program opens it only where the step captures a graph)."""

from benchmark.layer_metrics import span_device


def read(ctx):
    return span_device(ctx, ("ppo.sgd",), 1e3)
