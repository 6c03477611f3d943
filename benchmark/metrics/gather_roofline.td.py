"""gather_roofline.td: the lookup kernel (csrc/table_gather.cu) on the TD step's stream, least
time by bytes over kernel time (%): the kernel's time and launches from the trace, the bytes of
a launch from the TD entry's sampled steps (entries/td_chunk.py::sample_steps)."""

from benchmark.layer_metrics import td_gather_roofline


def read(ctx):
    return td_gather_roofline(ctx)
