"""Top-level entry points (counterpart of ``__graft_entry__.py``): the flagship
model's forward as one callable, and a multi-rank dry run of both learners
and the env.

:func:`entry` builds the PPO actor-critic at the width the repository
trains and ships, ``ActorCritic(filters=64, residual_blocks=4)`` (the meta
of ``docs/curves/ppo_{long,masked,tpu}_model.pkl``), in eval mode, and 256
empty int8 boards, on the card unless ``device`` says otherwise. Run it as

    fn, args = entry()
    logits, value = fn(*args)

:func:`dryrun_multichip` runs one step of each learner and a 1,048,576-board
env rollout over a mesh of ranks. JAX runs one process over several
devices; here each rank is a process of its own (``torchrun``), so the
module's ``__main__`` runs the forward and then the dry run over every
rank of the job:

    torchrun --standalone --nproc-per-node N -m gym2048_tpu_torch.entry [--device cpu]

Without ``torchrun`` it is a one-rank run.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from gym2048_tpu_torch.models.resnet import ActorCritic, boards_to_model_input
from gym2048_tpu_torch.parallel import mesh as pmesh

DRYRUN_BOARDS = 1_048_576  # BASELINE.json config 5's scale: ">=1M boards"
DRYRUN_ENV_STEPS = 4


def entry(device: str | torch.device = "cuda"):
    """``(fn, (model, boards))``: ``fn(model, boards)`` maps ``(B, 4, 4)``
    int8 exponent boards to ``(policy logits (B, 4), value (B,))`` in one
    eval-mode forward without gradients. The weights are flax's
    initialisation from a generator seeded 0."""
    model = ActorCritic(filters=64, residual_blocks=4, device=device)
    boards = torch.zeros((256, 4, 4), dtype=torch.int8, device=device)

    def fn(model, boards):
        with torch.no_grad():
            return model(boards_to_model_input(boards))

    return fn, (model, boards)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> None:
    """One step of each learner and a BASELINE config-5-scale env rollout on
    the mesh of ranks ``[0, n_devices)`` (pure data parallelism: the env
    batch split over ``data``, everything else replicated). Call it on
    every rank of the job, after :func:`~gym2048_tpu_torch.parallel.mesh.
    init_distributed`; with no process group it is a one-rank mesh. A rank
    outside the mesh builds it (a collective) and returns. Rank 0 prints
    one line a sub-check:

    1. a PPO ``train_iteration`` (gradient and BatchNorm ``all_reduce``s);
    2. a chunk-synchronous sharded TD chunk (``make_sharded_chunk``: one
       merge of the table a chunk);
    3. a 1,048,576-board rollout, 4 auto-reset random-legal steps.

    Raises ``ValueError`` when ``n_devices`` exceeds the job's ranks, and
    ``RuntimeError`` when a sub-check fails."""
    from gym2048_tpu_torch.bench import rollout
    from gym2048_tpu_torch.env import batched
    from gym2048_tpu_torch.train import ppo, td

    if n_devices > pmesh.world_size():
        raise ValueError(f"need {n_devices} ranks, have {pmesh.world_size()}")
    mesh = pmesh.make_mesh(range(n_devices))
    if mesh.get_coordinate() is None:
        return
    device = pmesh.rank_device(device)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    talk = pmesh.data_rank(mesh) == 0

    cfg = ppo.PPOConfig(total_timesteps=2048, n_envs=8 * n_devices, n_steps=8,
                        batch_size=16 * n_devices, n_epochs=1, filters=8, residual_blocks=1,
                        shuffle_mode="sharded")
    trainer = ppo.PPO(cfg, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))
    state, metrics = trainer.train_iteration(state)
    loss = float(metrics["loss"])
    _require(state.update_idx == 1, f"update_idx {state.update_idx} after one iteration")
    _require(loss == loss, "loss is NaN")
    if talk:
        print(f"dryrun_multichip 1/3 PPO OK: {n_devices} devices, env batch {cfg.n_envs} "
              f"sharded over mesh {shape}, loss {loss:.4f}", flush=True)

    td_cfg = td.TDConfig(n_envs=8 * n_devices, chunk_steps=8, init_value=100.0, tc=True,
                         alpha=1.0, alpha_final=1.0)
    tr = td.TDTrainer(td_cfg, device=device)
    td_state = td.shard_td_state(tr.init_state(torch.Generator(device=device).manual_seed(1)),
                                 mesh)
    td_state, td_metrics = tr.make_sharded_chunk(mesh)(td_state, 1.0)
    _require(bool(torch.isfinite(td_state["table"]).all()), "TD table not finite")
    if talk:
        print(f"dryrun_multichip 2/3 TD OK: sharded TC chunk over {n_devices} devices, "
              f"highest_exp {int(td_metrics['highest_exp'])}, table finite", flush=True)

    gen = torch.Generator(device=device).manual_seed(2)
    env_state = pmesh.shard_env_state(batched.reset(gen, DRYRUN_BOARDS, device=device), mesh)
    # each rank draws its own steps' uniforms (JAX folds the device into the key)
    gen.manual_seed(2 + 1000 * pmesh.data_rank(mesh))
    env_state, _ = rollout(env_state, DRYRUN_ENV_STEPS, gen)
    checksum = float(pmesh.all_reduce(env_state.score.sum(), mesh))
    _require(checksum > 0.0, f"score sum {checksum} after {DRYRUN_ENV_STEPS} steps")
    if talk:
        print(f"dryrun_multichip 3/3 env OK: {DRYRUN_BOARDS} boards sharded over {n_devices} "
              f"devices, {DRYRUN_ENV_STEPS} steps, score sum {checksum:.0f}", flush=True)
        print(f"dryrun_multichip OK: all 3 sub-checks on {n_devices} devices", flush=True)


def main(argv: list[str] | None = None) -> None:
    """The forward, then the dry run over every rank of the job (a process
    group this call started, it also ends)."""
    parser = argparse.ArgumentParser(description="The forward and the multi-rank dry run.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the card (default) or the CPU")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("CUDA is not available; pass --device cpu to run on the CPU")
    owned = not dist.is_initialized()
    pmesh.init_distributed(backend=pmesh.default_backend(args.device))
    try:
        fn, fn_args = entry(pmesh.rank_device(args.device))
        out = fn(*fn_args)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print("entry OK:", tuple(tuple(o.shape) for o in out), flush=True)
        dryrun_multichip(pmesh.world_size(), args.device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
