"""Weak scaling of the sharded env, PPO and TD over sub-meshes of ranks
(counterpart of ``scripts/scaling_bench.py``).

Every rank of the job runs it; each rate is measured on the meshes of ranks
``[0, n)`` for n in 1, 2, 4 and 8 up to the job's size, with fixed work per
rank, and rank 0 prints one JSON line a row with the JAX script's keys and
``env_scaling_eff`` (the env rate over n times the one-rank rate):

    torchrun --standalone --nproc-per-node N -m gym2048_tpu_torch.scaling_bench \\
        [--boards-per-device 8192] [--envs-per-device 512] [--length 64] \\
        [--repeats 5] [--md PATH] [--device cuda|cpu]

The backend is NCCL when each rank has a card of its own, else gloo (the
CPU, or ranks sharing a card: their rates are functional numbers, not
scaling). ``--md PATH`` also writes the rows as the JAX script's Markdown
table to PATH. Without ``torchrun`` it is a one-rank run.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from gym2048_tpu_torch.bench import rollout, timed_runs
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.parallel import mesh as pmesh
from gym2048_tpu_torch.train import ppo, td

MESH_SIZES = (1, 2, 4, 8)


def _best(fn, repeats: int) -> float:
    """The least seconds of ``repeats`` calls of ``fn`` (each ends with a
    host read) after one warm-up call."""
    fn()
    return timed_runs(fn, repeats)[0]


def env_rollout_rate(mesh, boards_per_device: int, length: int,
                     device: torch.device) -> float:
    """Random-legal rollout steps/s over the mesh, ``boards_per_device``
    boards a rank; each run ends with the score sum over the ranks."""
    n = pmesh.data_size(mesh)
    batch = n * boards_per_device
    gen = torch.Generator(device=device).manual_seed(0)
    state = pmesh.shard_env_state(batched.reset(gen, batch, device=device), mesh)
    gen.manual_seed(1000 * pmesh.data_rank(mesh))

    def run():
        nonlocal state
        state, _ = rollout(state, length, gen)
        float(pmesh.all_reduce(state.score.sum(), mesh))

    return batch * length / _best(run, 3)


def ppo_iteration_rate(mesh, envs_per_device: int, device: torch.device) -> float:
    """PPO env steps/s (rollout and update) over the mesh: 16 filters, 2
    blocks, 16 steps, 1 epoch, the sharded shuffle."""
    n = pmesh.data_size(mesh)
    cfg = ppo.PPOConfig(total_timesteps=10**9, n_envs=n * envs_per_device, n_steps=16,
                        batch_size=n * envs_per_device * 2, n_epochs=1, filters=16,
                        residual_blocks=2, shuffle_mode="sharded")
    trainer = ppo.PPO(cfg, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))

    def run():
        nonlocal state
        state, metrics = trainer.train_iteration(state)
        float(metrics["loss"])

    return cfg.rollout_size / _best(run, 2)


def td_chunk_rate(mesh, envs_per_device: int, device: torch.device,
                  chunk_steps: int = 32) -> float:
    """Chunk-synchronous TD env steps/s (greedy search and table update)
    over the mesh through ``make_sharded_chunk``: one merge a chunk."""
    n = pmesh.data_size(mesh)
    cfg = td.TDConfig(n_envs=n * envs_per_device, chunk_steps=chunk_steps, init_value=1000.0)
    tr = td.TDTrainer(cfg, device=device)
    chunk = tr.make_sharded_chunk(mesh)
    state = td.shard_td_state(tr.init_state(torch.Generator(device=device).manual_seed(0)),
                              mesh)

    def run():
        nonlocal state
        state, m = chunk(state, 0.1)
        float(m["episodes"])

    return cfg.n_envs * chunk_steps / _best(run, 3)


def markdown(rows: list[dict], args, platform: str) -> str:
    """The JAX script's table of the rows, with the port's reading."""
    lines = [
        "# Weak scaling — sharded env + PPO + TD over the device mesh",
        "",
        f"Platform: {platform}, boards/device={args.boards_per_device}, PPO envs/device="
        f"{args.envs_per_device}; every rate is the median of {args.repeats} independent "
        f"measurements (each best-of-3, PPO best-of-2).",
        "",
        "| devices | env batch | env steps/s | scaling eff | PPO steps/s | TD steps/s |",
        "|---|---|---|---|---|---|",
    ]
    for row in rows:
        lines.append(f"| {row['devices']} | {row['env_batch']} | {row['env_steps_per_s']:,} | "
                     f"{row['env_scaling_eff']} | {row['ppo_steps_per_s']:,} | "
                     f"{row['td_steps_per_s']:,} |")
    lines += [
        "",
        "Reading the numbers: each device is a rank, one process. Weak scaling holds the "
        "work per rank fixed, so ranks with a card each of their own (NCCL) should hold "
        "each rate per rank flat: the env rollout exchanges one scalar a run, the PPO "
        "update all-reduces the gradients and BatchNorm statistics, and the TD column "
        "(the chunk-synchronous sharded learner) merges the table once a chunk of 32 "
        "steps. Ranks that share a card or the CPU (gloo) share its time, and every "
        "all-reduce crosses the host: their rows show that the sharded program runs, not "
        "how it scales.",
    ]
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Weak scaling over sub-meshes of the job's ranks.")
    p.add_argument("--boards-per-device", type=int, default=8192)
    p.add_argument("--envs-per-device", type=int, default=512)
    p.add_argument("--length", type=int, default=64)
    p.add_argument("--md", metavar="PATH", help="also write the Markdown table to PATH")
    p.add_argument("--repeats", type=int, default=5,
                   help="independent measurements of each rate (median reported)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the CPU")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("CUDA is not available; pass --device cpu to run on the CPU")
    owned = not dist.is_initialized()
    pmesh.init_distributed(backend=pmesh.default_backend(args.device))
    try:
        device = pmesh.rank_device(args.device)
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        rows = []
        for n in (n for n in MESH_SIZES if n <= pmesh.world_size()):
            mesh = pmesh.make_mesh(range(n))  # a collective: every rank builds it
            if mesh.get_coordinate() is not None:
                def median(measure):
                    return float(np.median([measure() for _ in range(args.repeats)]))
                env_rate = median(lambda: env_rollout_rate(mesh, args.boards_per_device,
                                                           args.length, device))
                ppo_rate = median(lambda: ppo_iteration_rate(mesh, args.envs_per_device, device))
                td_rate = median(lambda: td_chunk_rate(mesh, args.envs_per_device, device))
                row = {"devices": n, "env_batch": n * args.boards_per_device,
                       "env_steps_per_s": round(env_rate), "ppo_steps_per_s": round(ppo_rate),
                       "td_steps_per_s": round(td_rate)}
                base = rows[0] if rows else row
                row["env_scaling_eff"] = round(
                    row["env_steps_per_s"] / (base["env_steps_per_s"] * n), 2)
                rows.append(row)
                if rank0:
                    print(json.dumps(row), flush=True)
            if dist.is_initialized():
                dist.barrier()  # the ranks outside this mesh wait for it
        if args.md and rank0:
            platform = (f"{device.type} x{pmesh.world_size()} ranks "
                        f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}"
                        f", {dist.get_backend() if dist.is_initialized() else 'one process'})")
            with open(args.md, "w") as f:
                f.write(markdown(rows, args, platform))
            print(f"wrote {args.md}", flush=True)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
