"""Standalone model evaluation CLI (counterpart of
``gym2048_tpu/tools/evaluate.py``).

* by default the reference protocol (train.py:122-229): N host episodes on
  the numpy adapter, epsilon-greedy, env seed 456+i / agent seed 123+i,
  2000-move cap, illegal reward -1, one batch-1 forward a move on
  ``--device``; writes ``scores_<label>.csv``;
* ``--fast``: all episodes in lockstep on the device
  (``evaluate_batched``), draws from a generator seeded ``--seed``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import torch

    from gym2048_tpu_torch import interop
    from gym2048_tpu_torch.train.eval import (
        evaluate_batched,
        evaluate_model,
        make_predict_fn,
        report_evaluation_results,
    )
    from gym2048_tpu_torch.utils.checkpoint import load_model

    p = argparse.ArgumentParser(description="Evaluate a saved 2048 model")
    p.add_argument("model", help="Model .pkl from train/pretrain_bc/ppo")
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--label", default="eval", help="scores_<label>.csv output label")
    p.add_argument("--fast", action="store_true", help="batched on-device evaluation")
    p.add_argument("--seed", type=int, default=0, help="generator seed for --fast mode")
    p.add_argument("--mask-illegal", action="store_true",
                   help="restrict the policy to legal moves (use for models trained "
                        "with --mask-illegal; --fast only)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    variables, _ = load_model(args.model)
    model = interop.resnet_from_variables(variables, device=args.device)

    if args.fast:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        results = evaluate_batched(model, args.episodes, args.epsilon, gen,
                                   mask_illegal=args.mask_illegal)
        print(f"Highest tile: {results['Highest tile']}, Average score: "
              f"{results['Average score']:.1f}, Max score: {results['Max score']:.1f}")
    else:
        results = evaluate_model(make_predict_fn(model), args.episodes, args.epsilon)
    report_evaluation_results(results, args.label)
    print(f"Wrote scores_{args.label}.csv")


if __name__ == "__main__":
    main()
