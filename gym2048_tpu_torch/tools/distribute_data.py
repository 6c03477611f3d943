"""Balance board orientations without growing the dataset (counterpart of
``gym2048_tpu/tools/distribute_data.py``).

Mirrors the reference ``distribute_training_data.py``: split into 8 equal
parts and apply a distinct flip/rotation combination to each, so all 8
dihedral orientations are uniformly represented.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from gym2048_tpu_torch.data import TrainingData

    p = argparse.ArgumentParser()
    p.add_argument("--output", "-o", default="outdata.csv")
    p.add_argument("input")
    args = p.parse_args(argv)

    data = TrainingData()
    data.import_csv(args.input)
    a, e = data.split()
    a, c = a.split()
    a, b = a.split()
    c, d = c.split()
    e, g = e.split()
    e, f = e.split()
    g, h = g.split()
    parts = [a, b, c, d, e, f, g, h]
    for part in parts:
        print(part.size())
    b.hflip()
    d.hflip()
    f.hflip()
    c.rotate(1)
    d.rotate(1)
    e.rotate(2)
    f.rotate(2)
    g.rotate(3)
    h.rotate(3)
    collect = TrainingData()
    for part in parts:
        collect.merge(part)
    collect.export_csv(args.output)
    print(f"{collect.size()} samples written to {args.output}")


if __name__ == "__main__":
    main()
