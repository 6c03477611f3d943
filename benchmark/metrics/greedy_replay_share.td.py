"""greedy_replay_share.td: the share of TD steps whose greedy search ran as one CUDA graph replay
(%): 100 x the program's counter ``td.greedy_replays`` over its counter ``td.steps``. None where
the program counts no replay (off the card, or a program without the replayed search)."""

from benchmark.program_spans import _summary


def read(ctx):
    summary = _summary()
    if summary is None:
        return None
    counters = summary["counters"]
    replays, steps = counters.get("td.greedy_replays", 0), counters.get("td.steps", 0)
    if replays <= 0 or steps <= 0:
        return None
    return 100.0 * replays / steps
