"""8x augment a training-data CSV (reference augment_training_data.py; counterpart of
``gym2048_tpu/tools/augment_data.py``)."""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from gym2048_tpu_torch.data import TrainingData

    p = argparse.ArgumentParser()
    p.add_argument("--output", "-o", default="data.csv")
    p.add_argument("input")
    args = p.parse_args(argv)

    data = TrainingData()
    data.import_csv(args.input)
    data.augment()
    data.export_csv(args.output)
    print(f"{data.size()} samples written to {args.output}")


if __name__ == "__main__":
    main()
