"""restart_host_us.td: host self time of the program's span ``td.restart`` a TD step (us):
spawn, fresh boards, the carousel's record and restart, the reset."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.restart")
