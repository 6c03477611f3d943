"""Recompute rewards for existing training data by replaying moves (counterpart of
``gym2048_tpu/tools/add_rewards.py``).

The reference ``add_rewards_to_training_data.py`` is stale/broken (it
unpacks 2 of 5 values from ``get_n`` and calls ``add`` without a next
board — SURVEY.md C25). This is the working equivalent: each (state,
action) is replayed on a scratch env via ``set_board`` + ``step`` to
recompute the merge-score reward; next boards and done flags are preserved.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    from gym2048_tpu_torch.core import rules_np
    from gym2048_tpu_torch.data import TrainingData

    p = argparse.ArgumentParser()
    p.add_argument("--output", "-o", default="data.csv")
    p.add_argument("input")
    args = p.parse_args(argv)

    data = TrainingData()
    data.import_csv(args.input)

    boards = data.get_x()
    actions = data.get_y_digit().reshape(-1)
    rewards = np.zeros(len(actions), dtype=float)
    for i in range(len(actions)):
        _, score, changed = rules_np.move(boards[i], int(actions[i]))
        rewards[i] = float(score) if changed else 0.0
    data._reward = rewards.reshape(-1, 1)

    print(f"Got {data.size()} data values")
    data.export_csv(args.output)


if __name__ == "__main__":
    main()
