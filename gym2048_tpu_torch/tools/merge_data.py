"""Merge training-data CSVs, filtering by highest tile (counterpart of
``gym2048_tpu/tools/merge_data.py``).

Mirrors the reference ``merge_training_data.py``: reject files whose highest
tile is below ``--min-high-tile``, cap accepted files at ``--max-files``,
export with a returns column.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from gym2048_tpu_torch.data import TrainingData

    p = argparse.ArgumentParser()
    p.add_argument("--output", "-o", default="data.csv")
    p.add_argument("--min-high-tile", "-m", type=int, default=1024,
                   help="Minimum highest tile for a game to be merged")
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("input", nargs="+")
    args = p.parse_args(argv)

    data = TrainingData()
    accepted = 0
    for path in args.input:
        part = TrainingData()
        part.import_csv(path)
        high = part.get_highest_tile()
        if high >= args.min_high_tile:
            data.merge(part)
            accepted += 1
            if args.max_files and accepted >= args.max_files:
                print(f"Stopping: --max-files limit of {args.max_files} "
                      f"reached")
                break
        else:
            print(f"Rejecting {path}: highest tile {high} is below "
                  f"--min-high-tile {args.min_high_tile}")
    print(f"Merged {data.size()} samples from {accepted} accepted files")
    data.export_csv(args.output, add_returns=True)


if __name__ == "__main__":
    main()
