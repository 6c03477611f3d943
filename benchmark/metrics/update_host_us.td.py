"""update_host_us.td: host self time of the program's span ``td.update`` a TD step (us): the
update block: the TD error and the tc_accumulate / td_update scatters."""

from benchmark.program_spans import td_host_us


def read(ctx):
    return td_host_us("td.update")
