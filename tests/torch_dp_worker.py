"""One rank of a data-parallel run of the port over gloo on the CPU (driven
by tests/test_torch_parallel.py, one process per rank).

Usage: python torch_dp_worker.py <rank> <world> <port> <outdir> <modes>

``modes`` is a comma-separated list of ``td`` (two sharded chunks of the
small net with TC, from init_state, through ``TDTrainer.learn``), ``td4x6``
(a sharded chunk of the staged 4x6 net at n_vals 4 with delayed TC and the
carousel, alpha 0: the table stays and the TC sums are exact in any order)
``ppo`` (one data-parallel PPO iteration at a tiny shape) and
``ppo_update`` (``PPO._update_epochs`` from the weights, buffer and
permutations in ``<outdir>/update_inputs.pt``), ``dryrun``
(``gym2048_tpu_torch.entry``'s ``main``: the forward and
``dryrun_multichip`` over every rank) and ``scaling``
(``gym2048_tpu_torch.scaling_bench``'s ``main`` at a tiny size, its table
written to ``<outdir>/scaling.md``); these two keep what the rank printed.
Each rank writes
``rank<r>.pt``: the whole TD states (collected from every rank), the PPO
parameters, metrics and collected rollout, and the updated weights, for
the test to compare across ranks and with its in-process results.
"""

import contextlib
import io
import os
import sys


def main() -> None:
    rank, world, port, outdir, modes = sys.argv[1:6]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world)
    import torch

    torch.set_num_threads(1)
    from gym2048_tpu_torch import entry, interop, scaling_bench
    from gym2048_tpu_torch.parallel import init_distributed, make_mesh
    from gym2048_tpu_torch.parallel import mesh as pmesh
    from gym2048_tpu_torch.train import ppo, td

    init_distributed(backend="gloo")
    mesh = make_mesh()
    assert pmesh.data_size(mesh) == int(world) and pmesh.data_rank(mesh) == int(rank)
    out = {}
    for mode in modes.split(","):
        if mode in ("td", "td4x6"):
            cfg = td.TDConfig(**TD_CONFIGS[mode])
            tr = td.TDTrainer(cfg, "cpu")
            state, hist = tr.learn(tr.init_state(), log_fn=None, mesh=mesh)
            out[mode] = {"state": td.gather_td_state(state, mesh),
                         "episodes": hist[-1].episodes}
        elif mode == "ppo":
            trainer = ppo.PPO(ppo.PPOConfig(**PPO_CONFIG), device="cpu", mesh=mesh)
            state = trainer.init_state()
            rollouts = []
            collect = trainer._collect_rollout

            def recorded(s):
                traj, last = collect(s)
                rollouts.append(traj)
                return traj, last

            trainer._collect_rollout = recorded
            state, metrics = trainer.train_iteration(state)
            traj = rollouts[0]
            out["ppo"] = {
                "params": {k: v.clone() for k, v in state.model.state_dict().items()},
                "metrics": {k: float(v) for k, v in metrics.items()},
                "rollout": [pmesh.gather_batch(x, mesh, axis=1)
                            for x in (traj.board, traj.reward, traj.done)],
            }
        elif mode == "ppo_update":
            inputs = torch.load(os.path.join(outdir, "update_inputs.pt"), weights_only=False)
            trainer = ppo.PPO(ppo.PPOConfig(**PPO_UPDATE_CONFIG), device="cpu", mesh=mesh)
            model = interop.resnet_from_variables(inputs["variables"], device="cpu")
            state = ppo.TrainState(model, trainer.make_optimizer(model), None, None)
            data = ppo.UpdateBatch(**{k: torch.from_numpy(v[:, trainer.cols].copy())
                                      for k, v in inputs["data"].items()})
            metrics = trainer._update_epochs(state, data, perms=list(inputs["perms"]))
            out["ppo_update"] = {"variables": interop.resnet_variables(model),
                                 "metrics": {k: float(v) for k, v in metrics.items()}}
        elif mode == "dryrun":
            out["dryrun"] = printed(entry.main, ["--device", "cpu"])
        elif mode == "scaling":
            out["scaling"] = printed(scaling_bench.main, [
                *SCALING_ARGS, "--md", os.path.join(outdir, "scaling.md"), "--device", "cpu"])
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


def printed(main, argv: list[str]) -> str:
    """What ``main(argv)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


TD_CONFIGS = {
    "td": dict(n_envs=32, chunk_steps=8, total_steps=32 * 8 * 2, init_value=100.0, tc=True,
               alpha=1.0, alpha_final=1.0, seed=3),
    "td4x6": dict(n_envs=32, chunk_steps=4, total_steps=32 * 4, arch="4x6", n_vals=4,
                  thresholds=(2, 3), tc=True, tc_every=2, carousel=0.5, carousel_slots=8,
                  alpha=0.0, alpha_final=0.0, init_value=0.0, seed=4),
}
PPO_CONFIG = dict(total_timesteps=4096, n_envs=16, n_steps=8, batch_size=32, n_epochs=2,
                  filters=8, residual_blocks=1, shuffle_mode="sharded", seed=2)
# 2 epochs of 4 minibatches of 2 time rows x 8 envs
PPO_UPDATE_CONFIG = dict(total_timesteps=64, n_envs=8, n_steps=8, batch_size=16, n_epochs=2,
                         filters=8, residual_blocks=1, shuffle_mode="sharded")
SCALING_ARGS = ["--boards-per-device", "64", "--envs-per-device", "16", "--length", "4",
                "--repeats", "1"]

if __name__ == "__main__":
    main()
