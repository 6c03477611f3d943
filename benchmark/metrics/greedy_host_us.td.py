"""greedy_host_us.td: host self time of the program's span ``td.greedy`` a TD step (us): the
greedy search: move_all, argmax and the chosen afterstate's gathers."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.greedy")
