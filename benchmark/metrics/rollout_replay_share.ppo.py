"""rollout_replay_share.ppo: the share of PPO rollout steps that ran as one CUDA graph replay
(%): 100 x the program's counter ``ppo.rollout_replays`` over its counter ``ppo.rollout_steps``.
None where the program counts no replay (off the card, or a program without the replayed
step)."""

from benchmark.program_spans import _summary


def read(ctx):
    summary = _summary()
    if summary is None:
        return None
    counters = summary["counters"]
    replays, steps = counters.get("ppo.rollout_replays", 0), counters.get("ppo.rollout_steps", 0)
    if replays <= 0 or steps <= 0:
        return None
    return 100.0 * replays / steps
