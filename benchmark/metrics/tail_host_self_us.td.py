"""tail_host_self_us.td: host self time of the program's span ``td.tail`` a TD step (us): the
copies of the greedy search's results into the step tail's buffers and the tail's CUDA graph
replay (the TD error, delayed TC's scatter-accumulate, the bookkeeping, spawn, the carousel and
the reset). None where the program has no such span."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.tail")
