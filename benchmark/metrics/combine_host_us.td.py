"""combine_host_us.td: host self time of the program's span ``td.combine`` a TD step (us):
the delayed-TC combine and the zeroing of its pending buffers."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.combine")
