"""Behavioural-cloning pre-training CLI for the PPO policy (counterpart of
``gym2048_tpu/tools/pretrain_bc.py``).

Mirrors the reference ``pretrain_bc.py``: load and merge CSVs, optional 8x
augmentation, cross-entropy training of the PPO network's policy head, and
a saved model ready for ``ppo --pretrained``. The model file is the JAX
package's (``save_model`` of the flax variable tree, through
``interop.resnet_variables``), so both packages load it. Flag surface
matches pretrain_bc.py:147-159, plus ``--device``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Behavioural cloning pre-training for 2048 PPO")
    p.add_argument("data", nargs="+", help="CSV file(s)")
    p.add_argument("--output", default=f"bc_pretrained_{int(time.time())}",
                   help="Output model path (.pkl appended)")
    p.add_argument("--no-augment", action="store_true",
                   help="Disable 8x board augmentation")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--residual-blocks", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    import torch

    from gym2048_tpu_torch import interop
    from gym2048_tpu_torch.data import TrainingData
    from gym2048_tpu_torch.train import BCConfig, build_bc_trainer_for_ppo
    from gym2048_tpu_torch.utils.checkpoint import save_model

    args = parse_args(argv)
    print(f"Loading data from: {args.data}")
    td = TrainingData()
    for path in args.data:
        part = TrainingData()
        part.import_csv(path)
        td.merge(part)
    print(f"  {td.size()} samples loaded")

    if not args.no_augment:
        td.augment()
        print(f"  {td.size()} samples after augmentation (8x flip/rotate)")

    actions = td.get_y_digit().flatten()
    counts = np.bincount(actions, minlength=4)
    print(f"Action distribution: up={counts[0]} right={counts[1]} "
          f"down={counts[2]} left={counts[3]}")

    trainer = build_bc_trainer_for_ppo(
        filters=args.filters, residual_blocks=args.residual_blocks,
        config=BCConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                        seed=args.seed),
        device=args.device)
    trainer.init_model(torch.Generator(device=trainer.device).manual_seed(args.seed))
    print(f"Training BC: {td.size()} samples, {args.epochs} epochs, batch={args.batch_size}")
    model, _ = trainer.fit(td.get_x_exponents(), actions)

    out = args.output if args.output.endswith(".pkl") else args.output + ".pkl"
    save_model(out, interop.resnet_variables(model),
               {"filters": args.filters, "residual_blocks": args.residual_blocks,
                "model": "ActorCritic"})
    print(f"Pre-trained model saved to {out}")
    print(f"Use with: python -m gym2048_tpu_torch.tools.ppo --pretrained {out}")


if __name__ == "__main__":
    main()
