"""2x horizontal-flip a training-data CSV (reference hflip_training_data.py; counterpart of
``gym2048_tpu/tools/hflip_data.py``)."""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from gym2048_tpu_torch.data import TrainingData

    p = argparse.ArgumentParser()
    p.add_argument("--output", "-o", default="output.csv")
    p.add_argument("input")
    args = p.parse_args(argv)

    data = TrainingData()
    data.import_csv(args.input)
    flipped = data.copy()
    flipped.hflip()
    data.merge(flipped)
    data.export_csv(args.output)
    print(f"{data.size()} samples written to {args.output}")


if __name__ == "__main__":
    main()
