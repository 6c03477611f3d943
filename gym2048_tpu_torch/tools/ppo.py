"""PPO training CLI (counterpart of ``gym2048_tpu/tools/ppo.py``).

Mirrors the reference ``ppo_train.py`` flag surface (ppo_train.py:195-233)
and training flow (:122-188): optional BC warm start, highest-tile metric,
periodic checkpoints, periodic greedy-episode videos, JSONL (and, where it
is installed, TensorBoard) logging, final model save. Extras, as in the
JAX CLI: any env batch size, ``--resume`` from the latest checkpoint (the
whole state: weights, BatchNorm statistics, Adam, the schedule's count,
the envs, the generator, ``update_idx``), ``--bf16``, ``--mask-illegal``,
``--mesh``; and ``--device``.

``--mesh`` trains data-parallel over the ranks of ``torchrun --standalone
--nproc-per-node N -m gym2048_tpu_torch.tools.ppo --mesh ...`` (NCCL when
each rank has a card of its own, else gloo), with the sharded minibatch
shuffle forced, as JAX's CLI does. Every rank runs the iterations; rank 0
alone logs, writes checkpoints (the env state collected from every rank)
and the final model, and records videos. ``--resume`` loads the whole
state on every rank and shards it.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="PPO training for 2048")
    p.add_argument("--total-timesteps", type=int, default=5_000_000)
    p.add_argument("--n-envs", type=int, default=8,
                   help="Number of parallel environments (on the card: 1024+)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n-steps", type=int, default=2048, help="Steps collected per rollout")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--n-epochs", type=int, default=4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--clip-coef", type=float, default=0.2)
    p.add_argument("--vf-coef", type=float, default=0.5)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--max-grad-norm", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--anneal-lr", action="store_true",
                   help="Linearly decay LR to 0 over training")
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--residual-blocks", type=int, default=4)
    p.add_argument("--pretrained", default=None,
                   help="Path to BC pre-trained model from pretrain_bc")
    p.add_argument("--video-freq", type=int, default=1_000_000,
                   help="Record a video every N timesteps (0 = disable)")
    p.add_argument("--log-interval", type=int, default=10, help="Log every N rollouts")
    p.add_argument("--save-interval", type=int, default=100,
                   help="Checkpoint every N rollouts (0 = disable)")
    p.add_argument("--illegal-move-reward", type=float, default=0.0)
    p.add_argument("--log2-rewards", action="store_true",
                   help="log2-compress rewards before GAE (default off = exact SB3 "
                        "semantics)")
    p.add_argument("--reward-scale", type=float, default=1.0)
    p.add_argument("--mask-illegal", action="store_true",
                   help="Mask illegal actions in the policy (the reference/SB3 has no "
                        "legality oracle)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 params/updates)")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel training over the ranks of torchrun: the env batch "
                        "shards, parameters replicate, gradients all-reduce (also switches "
                        "to the sharded minibatch shuffle)")
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("--ckpt-dir", default="./checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--run-name", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    import torch

    from gym2048_tpu_torch import interop
    from gym2048_tpu_torch.parallel import mesh as pmesh
    from gym2048_tpu_torch.train import PPO, PPOConfig
    from gym2048_tpu_torch.utils.checkpoint import Checkpointer, load_model, save_model
    from gym2048_tpu_torch.utils.metrics import MetricsLogger

    args = parse_args(argv)
    run_name = args.run_name or f"ppo_{int(time.time())}"
    device, mesh = torch.device(args.device), None
    if args.mesh:
        pmesh.init_distributed(backend=pmesh.default_backend(device))
        mesh = pmesh.make_mesh()
        device = pmesh.rank_device(device)
    rank0 = pmesh.data_rank(mesh) == 0
    if rank0:
        print(f"torch {torch.__version__}, device {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    cfg = PPOConfig(
        total_timesteps=args.total_timesteps, n_envs=args.n_envs, seed=args.seed,
        n_steps=args.n_steps, batch_size=args.batch_size, n_epochs=args.n_epochs,
        gamma=args.gamma, gae_lambda=args.gae_lambda, clip_coef=args.clip_coef,
        vf_coef=args.vf_coef, ent_coef=args.ent_coef, max_grad_norm=args.max_grad_norm,
        lr=args.lr, anneal_lr=args.anneal_lr, filters=args.filters,
        residual_blocks=args.residual_blocks, illegal_move_reward=args.illegal_move_reward,
        log2_rewards=args.log2_rewards, reward_scale=args.reward_scale,
        mask_illegal=args.mask_illegal,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        # data parallel needs the device-local shuffle, as in JAX's CLI
        **({"shuffle_mode": "sharded"} if args.mesh else {}))
    ppo = PPO(cfg, device=device, mesh=mesh)
    state = ppo.init_state()

    ckpt = Checkpointer(args.ckpt_dir) if args.save_interval > 0 else None
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        state = pmesh.shard_train_state(ckpt.restore(like=ppo.global_state(state)), mesh)
        if rank0:
            print(f"Resumed from checkpoint step {state.update_idx}")
    elif args.pretrained:
        variables, meta = load_model(args.pretrained)
        if meta.get("model") != "ActorCritic":
            raise ValueError(f"--pretrained needs an ActorCritic model, got meta {meta}")
        state.model.load_state_dict(interop.resnet_state_dict(variables))
        if rank0:
            print(f"Loaded pre-trained policy weights from {args.pretrained}")
    if mesh is not None and rank0:
        print(f"data-parallel training over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    logger = MetricsLogger(args.log_dir, run_name) if rank0 else None
    last_video = {"t": 0}

    def callback(update: int, metrics: dict, state) -> None:
        timesteps = metrics["timesteps"]
        if rank0 and update % args.log_interval == 0:
            logger.log(timesteps, {
                "rollout/ep_rew_mean": metrics["ep_return_rolling"],
                "rollout/ep_len_mean": metrics["ep_len_mean"],
                "rollout/highest_tile": metrics["highest_tile_rolling"],
                "train/loss": metrics["loss"],
                "train/policy_loss": metrics["policy_loss"],
                "train/value_loss": metrics["value_loss"],
                "train/entropy": metrics["entropy"],
                "train/approx_kl": metrics["approx_kl"],
                "train/clip_frac": metrics["clip_frac"],
            })
            print(f"update {update}/{cfg.n_updates} steps {timesteps} "
                  f"ep_rew {metrics['ep_return_rolling']:.1f} "
                  f"highest {metrics['highest_tile_rolling']:.0f} "
                  f"kl {metrics['approx_kl']:.4f}")
        if ckpt is not None and update % args.save_interval == 0:
            whole = ppo.global_state(state)  # a collective: every rank takes part
            if rank0:
                ckpt.save(update, whole)
        if rank0 and args.video_freq > 0 and timesteps - last_video["t"] >= args.video_freq:
            last_video["t"] = timesteps
            _record_video(state, run_name, timesteps)

    state = ppo.learn(state, callback=callback, log_interval=1)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if not rank0:
        return state

    final_path = f"ppo_model_final_{int(time.time())}.pkl"
    save_model(final_path, interop.resnet_variables(state.model),
               {"filters": args.filters, "residual_blocks": args.residual_blocks,
                "model": "ActorCritic"})
    print(f"\nTraining complete. Model saved to {final_path}")
    logger.close()
    return state


def _record_video(state, run_name: str, timesteps: int) -> None:
    """One greedy episode of the current policy on the host adapter, saved
    as ``./videos/<run_name>_<timesteps>.gif``."""
    import numpy as np

    from gym2048_tpu_torch.train.eval import make_predict_fn
    from gym2048_tpu_torch.utils.video import record_episode_gif

    predict = make_predict_fn(state.model.eval())
    stats = record_episode_gif(lambda obs: int(np.argmax(predict(obs))),
                               f"./videos/{run_name}_{timesteps}.gif")
    print(f"  video: {stats['path']} ({stats['steps']} steps, highest {stats['highest']})")


if __name__ == "__main__":
    main()
