"""chunk_host_us.td: host self time of the program's span ``td.chunk`` a TD step (us): the
chunk's own host work: the draws, the Python step loop, the episode bookkeeping, the stacked
stats."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.chunk")
