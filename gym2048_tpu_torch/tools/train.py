"""Supervised training pipeline CLI (counterpart of
``gym2048_tpu/tools/train.py``).

Mirrors the reference ``train.py`` main (train.py:232-293): load CSV ->
shuffle -> 80/20 split -> augment + dedup the training split -> pre-train
evaluation -> train -> validation metrics -> save model -> post-train
evaluation. Flag surface matches train.py:239-247, with ``--fast-eval``
(the batched evaluator on the device instead of the episode-by-episode
host protocol) and ``--device``. The shuffle draws from numpy's global
generator, as the reference's does; the model's weights and the epochs'
permutations come from generators seeded ``--seed``. The model file is the
JAX package's layout (``interop.resnet_variables``).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input", help="Training data CSV file")
    p.add_argument("--output-model", default="model.pkl", help="Output model path")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--residual-blocks", type=int, default=8)
    p.add_argument("--eval-episodes", type=int, default=10)
    p.add_argument("--eval-epsilon", type=float, default=0.1)
    p.add_argument("--fast-eval", action="store_true",
                   help="Use the batched on-device evaluator")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the pipeline; returns the validation metrics."""
    import torch

    from gym2048_tpu_torch import interop
    from gym2048_tpu_torch.data import TrainingData
    from gym2048_tpu_torch.models import Game2048Model
    from gym2048_tpu_torch.train import BCConfig, BCTrainer
    from gym2048_tpu_torch.train.eval import (
        evaluate_batched,
        evaluate_model,
        make_predict_fn,
        report_evaluation_results,
    )
    from gym2048_tpu_torch.utils.checkpoint import save_model

    args = parse_args(argv)
    device = torch.device(args.device)
    print(f"torch {torch.__version__}, device {device}")

    model = Game2048Model(filters=args.filters, residual_blocks=args.residual_blocks,
                          device=device)
    trainer = BCTrainer(model, BCConfig(epochs=args.epochs, batch_size=args.batch_size,
                                        lr=args.lr, seed=args.seed))
    trainer.init_model(torch.Generator(device=device).manual_seed(args.seed))

    data = TrainingData()
    data.import_csv(args.input)
    data.shuffle()
    training, validation = data.split(0.8)
    training.augment()
    training.make_boards_unique()
    print(f"{training.size()} training / {validation.size()} validation samples")

    def run_eval(label):
        if args.eval_episodes <= 0:
            return
        if args.fast_eval:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            results = evaluate_batched(model, args.eval_episodes, args.eval_epsilon, gen)
        else:
            results = evaluate_model(make_predict_fn(model), args.eval_episodes,
                                     args.eval_epsilon)
        report_evaluation_results(results, label)
        print(f"[{label}] Highest tile: {results['Highest tile']}, "
              f"Average score: {results['Average score']:.1f}, "
              f"Max score: {results['Max score']:.1f}")

    run_eval("pretraining")
    trainer.fit(training.get_x_exponents(), training.get_y_digit())
    val = trainer.evaluate(validation.get_x_exponents(), validation.get_y_digit())
    print(f"Validation — loss: {val['loss']:.4f} — accuracy: {val['accuracy']:.4f}")

    save_model(args.output_model, interop.resnet_variables(model),
               {"filters": args.filters, "residual_blocks": args.residual_blocks,
                "model": "Game2048Model"})
    print(f"Model saved to {args.output_model}")
    run_eval("trained")
    return val


if __name__ == "__main__":
    main()
