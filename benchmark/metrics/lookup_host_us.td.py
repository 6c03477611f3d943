"""lookup_host_us.td: host self time of the program's span ``td.lookup`` a TD step (us): the
lookup: indices_batch, the gather_values launch, the sum over symmetries."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.lookup")
