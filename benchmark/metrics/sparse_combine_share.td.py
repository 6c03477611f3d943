"""sparse_combine_share.td: the share of TD steps whose delayed-TC window ended in the combine over
the window's touched entries (%): 100 x the program's counter ``td.sparse_combines`` x the cell's
``tc_every`` over its counter ``td.steps``. None where the program counts no such combine (a program
that combines every entry of the table)."""

from benchmark.program_spans import _summary


def read(ctx):
    summary = _summary()
    if summary is None:
        return None
    counters = summary["counters"]
    combines, steps = counters.get("td.sparse_combines", 0), counters.get("td.steps", 0)
    if combines <= 0 or steps <= 0:
        return None
    return 100.0 * combines * int(ctx.entry.traffic["tc_every"]) / steps
