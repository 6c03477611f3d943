"""Data parallel in the port (gym2048_tpu_torch.parallel, the sharded TD
chunk, data-parallel PPO) against the JAX package's mesh code.

* The sharded TD chunk with its ranks run in turn in one process (each
  rank's ``ShardedChunk.local``, the sums over the ranks, each rank's
  ``merge``), fed the uniforms that each JAX device draws from its folded
  key, equals JAX's ``make_sharded_chunk`` on 2 and 4 of conftest's CPU
  devices bit for bit, where every sum is exact: a table of small integers
  and dyadic TD errors, with the table moving over 2 ranks (the merge adds
  two changes, in either order the same) and frozen (alpha 0, the TC sums
  exact in any order) over 2 and 4.
* On one rank the sharded chunk and ``learn(mesh=...)`` are ``train_chunk``
  bit for bit.
* Real processes over gloo (tests/torch_dp_worker.py, one per rank, one
  torch thread each): the replicas stay bit-identical and equal the
  ranks-in-turn result (exact-sum configs at 4 ranks); the 2-rank PPO
  iteration's rollout, collected, is the single-process rollout of the same
  seed bit for bit, and its metrics are within 1e-5 of the single
  process's (the same sums in another grouping); the 2-rank update from
  JAX's weights, data and permutations holds to JAX's ``_update_epochs``
  within tests/test_torch_ppo.py's tolerances for whole updates. The CLIs
  run under 2 ranks: ``train.td --sharded`` (then ``--resume`` of its
  checkpoint under 1) and ``tools.ppo --mesh``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_td import assert_bits, feed, jax_draws
from torch.distributed.device_mesh import DeviceMesh

from gym2048_tpu.parallel import make_mesh as jmake_mesh
from gym2048_tpu.train import ppo as jppo
from gym2048_tpu.train import td as jtd
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.parallel import (init_distributed, make_mesh, replicate, shard_batch,
                                        shard_env_state, shard_train_state)
from gym2048_tpu_torch.parallel import mesh as pmesh
from gym2048_tpu_torch.train import ppo, td

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "torch_dp_worker.py"
sys.path.insert(0, str(WORKER.parent))
import torch_dp_worker  # noqa: E402

WORKER_TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rank_mesh(world: int, rank: int) -> DeviceMesh:
    """The mesh of ``world`` ranks as rank ``rank`` sees it, without a
    process group: for running the ranks in turn in one process."""
    return DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"), _init_backend=False, _rank=rank)


def clone_state(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Generator):
            g = torch.Generator(device=v.device)
            g.set_state(v.get_state())
            out[k] = g
        else:
            out[k] = v.clone()
    return out


def ranks_in_turn(trainer, states, alpha, draws=None):
    """One sharded chunk of every rank's ``states[r]``, run in turn: each
    rank's local chunk, the sums (and the max) over the ranks, each rank's
    merge. ``draws[r]``, when given, is rank r's list of step draws."""
    world = len(states)
    chunks = [trainer.make_sharded_chunk(rank_mesh(world, r)) for r in range(world)]
    outs = []
    for r, (chunk, state) in enumerate(zip(chunks, states)):
        if draws is not None:
            feed(trainer, draws[r])
        outs.append(chunk.local(state, alpha))
    if draws is not None:
        del trainer._draws
    totals = {k: outs[0][1][k].clone() for k in outs[0][1]}
    for _, parts in outs[1:]:
        for k, v in parts.items():
            totals[k] = torch.maximum(totals[k], v) if k == "highest" else totals[k] + v
    return [chunk.merge(state, new, totals)
            for chunk, state, (new, _) in zip(chunks, states, outs)]


# ------------------------------------------------------------ the mesh

def test_mesh_without_a_process_group():
    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert pmesh.data_size(mesh) == 1 and pmesh.data_rank(mesh) == 0
    assert not torch.distributed.is_initialized()
    x = torch.arange(6)
    assert shard_batch(x, mesh) is x and replicate(x, mesh) is x
    assert pmesh.gather_batch(x, mesh) is x and pmesh.all_reduce(x, mesh) is x
    with pytest.raises(ValueError):
        make_mesh(devices=[0, 1])
    with pytest.raises(ValueError):
        make_mesh(devices=[0], model_parallelism=2)


def test_init_distributed_falls_back_only_without_a_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.warns(UserWarning, match="no coordinator configured"):
        init_distributed()
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError):  # MASTER_PORT missing: the job must not train alone
        init_distributed(backend="gloo")
    assert not torch.distributed.is_initialized()


def test_shard_layout_by_rank():
    """Rank r's block of each batch-led leaf (and of the reservoirs'
    slots), the rest replicated; EnvState and TrainState by field."""
    x = torch.arange(24).reshape(8, 3)
    blocks = [shard_batch(x, rank_mesh(4, r)) for r in range(4)]
    assert torch.equal(torch.cat(blocks), x)
    with pytest.raises(ValueError):
        shard_batch(torch.arange(6), rank_mesh(4, 0))
    cfg = td.TDConfig(n_envs=8, arch="4x6", n_vals=4, thresholds=(2, 3), tc=True,
                      carousel=0.5, carousel_slots=4, alpha=1.0, alpha_final=1.0,
                      init_value=0.0)
    state = td.TDTrainer(cfg, "cpu").init_state()
    for r in range(2):
        s = td.shard_td_state(state, rank_mesh(2, r))
        for k in ("boards", "score", "prev_after", "prev_v", "prev_valid"):
            assert torch.equal(s[k], state[k][4 * r:4 * r + 4]), k
        for k in ("car_boards", "car_filled"):
            assert torch.equal(s[k], state[k][:, 2 * r:2 * r + 2]), k
        for k in ("table", "tc_e", "tc_a", "generator"):
            assert s[k] is state[k]
    trainer = ppo.PPO(ppo.PPOConfig(n_envs=8, n_steps=4, batch_size=16, filters=8,
                                    residual_blocks=1), device="cpu")
    full = trainer.init_state()
    part = shard_train_state(full, rank_mesh(2, 1))
    assert part.model is full.model and part.generator is full.generator
    for f in dataclasses.fields(full.env_state):
        assert torch.equal(getattr(part.env_state, f.name), getattr(full.env_state, f.name)[4:])
    assert torch.equal(shard_env_state(full.env_state, rank_mesh(2, 0)).board,
                       full.env_state.board[:4])


def test_sharded_chunk_checks_the_split():
    cfg = td.TDConfig(n_envs=6, arch="4x6", n_vals=4, thresholds=(2, 3), tc=True,
                      carousel=0.5, carousel_slots=6, init_value=0.0)
    tr = td.TDTrainer(cfg, "cpu")
    with pytest.raises(ValueError, match="n_envs"):
        tr.make_sharded_chunk(rank_mesh(4, 0))
    with pytest.raises(ValueError, match="carousel_slots"):
        td.TDTrainer(dataclasses.replace(cfg, n_envs=8), "cpu").make_sharded_chunk(
            rank_mesh(4, 0))
    with pytest.raises(ValueError, match="sharded"):
        ppo.PPO(ppo.PPOConfig(n_envs=8, n_steps=4, batch_size=16), device="cpu",
                mesh=rank_mesh(2, 0))


# --------------------------------------------- the TD chunk against JAX

BIG = dict(arch="4x6", n_vals=4, thresholds=(2, 3), n_envs=16)
JAX_CASES = {
    # the table moves; two ranks' changes merge in one addition
    "td": dict(BIG, chunk_steps=2, alpha=0.5, alpha_final=0.5, init_value=0.0),
    # alpha 0: the table stays, the TC sums of dyadic errors are exact in any order
    "frozen": dict(BIG, chunk_steps=4, tc=True, tc_every=2, carousel=0.5, carousel_slots=8,
                   alpha=0.0, alpha_final=0.0, init_value=0.0),
}


@pytest.mark.parametrize("world, case", [(2, "td"), (2, "frozen"), (4, "frozen")])
def test_sharded_chunk_matches_jax(world, case):
    kw = JAX_CASES[case]
    jtr = jtd.TDTrainer(jtd.TDConfig(**kw))
    tr = td.TDTrainer(td.TDConfig(**kw), "cpu")
    rng = np.random.default_rng(world)
    start = {k: np.asarray(v) for k, v in jtr.init_state(jax.random.PRNGKey(world)).items()}
    start["table"] = rng.integers(-8, 8, start["table"].shape).astype(np.float32)
    if kw.get("tc"):
        start["tc_e"] = rng.integers(-4, 4, start["tc_e"].shape).astype(np.float32)
        start["tc_a"] = np.abs(start["tc_e"]) + rng.integers(0, 3, start["tc_a"].shape).astype(
            np.float32)
    mesh = jmake_mesh(jax.devices()[:world])
    alpha = tr.cfg.alpha
    jout, jm = jtr.make_sharded_chunk(mesh)(
        jtd.shard_td_state({k: jnp.asarray(v) for k, v in start.items()}, mesh),
        jnp.float32(alpha))
    jout = {k: np.asarray(v) for k, v in jout.items()}

    n = kw["n_envs"] // world
    draws = []
    for r in range(world):
        key, rank_draws = jax.random.fold_in(jnp.asarray(start["key"]), r), []
        for _ in range(kw["chunk_steps"]):
            key, d = jax_draws(key, n, bool(kw.get("carousel")))
            rank_draws.append(d)
        draws.append(rank_draws)
    whole = interop.train_state_from_numpy(start, "cpu", generator=torch.Generator())
    states = [td.shard_td_state(clone_state(whole), rank_mesh(world, r)) for r in range(world)]
    merged = ranks_in_turn(tr, states, alpha, draws)

    for r, (got, metrics) in enumerate(merged):
        mine = td.gather_td_state(got, None)
        for k in set(mine) - {"generator"}:
            want = jout[k]
            if k in td._BATCH_KEYS:
                want = np.split(want, world)[r]
            elif k in td._SLOT_KEYS:
                want = np.split(want, world, axis=1)[r]
            if k == "car_boards":  # row 0 takes the non-crossing envs' writes
                assert_bits(mine[k][1:], want[1:], k)
            else:
                assert_bits(mine[k], want, f"rank {r}: {k}")
        for k in ("episodes", "ep_score_mean", "highest_exp"):
            assert_bits(metrics[k], np.asarray(jm[k]), k)
    if case == "td":
        assert not np.array_equal(jout["table"], start["table"])  # the merge moved it
    else:
        assert not np.array_equal(jout["tc_a"], start["tc_a"])
    assert set(merged[0][0]) == set(jout) - {"key"} | {"generator"}


@pytest.mark.parametrize("case", ["small", "staged"])
def test_one_rank_is_train_chunk(case):
    kw = (dict(n_envs=16, chunk_steps=4, init_value=100.0, tc=True, alpha=1.0,
               alpha_final=1.0, total_steps=16 * 4 * 2) if case == "small"
          else dict(BIG, chunk_steps=4, tc=True, tc_every=2, carousel=0.5, carousel_slots=8,
                    alpha=1.0, alpha_final=1.0, total_steps=16 * 4 * 2))
    tr = td.TDTrainer(td.TDConfig(**kw), "cpu")
    want, _ = tr.train_chunk(tr.init_state(), 1.0)
    got, _ = tr.make_sharded_chunk(make_mesh())(tr.init_state(), 1.0)
    for k in want:
        if k == "generator":
            assert torch.equal(got[k].get_state(), want[k].get_state())
        else:
            assert_bits(got[k], want[k], k)
    a, ha = tr.learn(log_fn=None)
    b, hb = tr.learn(log_fn=None, mesh=make_mesh())
    assert [dataclasses.replace(h, wall=0) for h in ha] == [
        dataclasses.replace(h, wall=0) for h in hb]
    for k in a:
        if k != "generator":
            assert_bits(b[k], a[k], k)


# ------------------------------------------------------ real processes

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    return env


def _wait(procs, what):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what}: rank {i} failed (rc={p.returncode}):\n{out}"
    return outs


def run_workers(world: int, outdir: Path, modes: str) -> list[dict]:
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), port,
                               str(outdir), modes], env=_env(), cwd=outdir,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    _wait(procs, f"{world} workers")
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ``python -m <module> <args>``, with TensorBoard blocked as
# tests/test_torch_tools.py blocks it (importing it loads TensorFlow, ~15 s)
RUN_MODULE = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
              "sys.argv = sys.argv[1:]; runpy.run_module(sys.argv[0], run_name='__main__')")


def run_cli(module: str, args: list[str], world: int, cwd: Path) -> list[str]:
    """``python -m module args`` as ``world`` ranks, as torchrun starts them."""
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = _env()
        env.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen([sys.executable, "-c", RUN_MODULE, module, *args],
                                      env=env, cwd=cwd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return _wait(procs, module)


def in_process_td(mode: str, world: int) -> dict:
    """The worker's TD run (``TDTrainer.learn`` over its chunks) with the
    ranks run in turn in this process: the whole state after it."""
    cfg = td.TDConfig(**torch_dp_worker.TD_CONFIGS[mode])
    tr = td.TDTrainer(cfg, "cpu")
    whole = tr.init_state()
    states = [td.shard_td_state(clone_state(whole), rank_mesh(world, r)) for r in range(world)]
    chunks = cfg.total_steps // (cfg.n_envs * cfg.chunk_steps)
    for c in range(chunks):
        alpha = cfg.alpha + (cfg.alpha_final - cfg.alpha) * c / max(chunks - 1, 1)
        states = [s for s, _ in ranks_in_turn(tr, states, alpha)]
    out = {}
    for k in states[0]:
        if k in td._BATCH_KEYS or k in td._SLOT_KEYS:
            out[k] = torch.cat([s[k] for s in states], dim=1 if k in td._SLOT_KEYS else 0)
        else:
            out[k] = states[0][k]
    return out


def assert_td_states_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        if k == "generator":
            assert torch.equal(got[k].get_state(), want[k].get_state()), what
        else:
            assert_bits(got[k], want[k].numpy(), f"{what}: {k}")


def jax_update_inputs(path: Path) -> dict:
    """JAX's weights, a seeded (T, B) update buffer and JAX's epoch
    permutations, saved for the workers' ``ppo_update``; JAX's
    ``_update_epochs`` result."""
    cfg = torch_dp_worker.PPO_UPDATE_CONFIG
    jtrainer = jppo.PPO(jppo.PPOConfig(**cfg))
    js = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    t_len, b = cfg["n_steps"], cfg["n_envs"]
    data = dict(board=rng.integers(0, 11, (t_len, b, 4, 4)).astype(np.int8),
                action=rng.integers(0, 4, (t_len, b)).astype(np.int32),
                logprob=np.log(rng.uniform(0.1, 0.5, (t_len, b))).astype(np.float32),
                adv=rng.normal(size=(t_len, b)).astype(np.float32) * 3,
                ret=rng.normal(size=(t_len, b)).astype(np.float32) * 10)
    key = jax.random.PRNGKey(5)
    params, stats, _, metrics = jax.jit(jtrainer._update_epochs)(
        js, jppo._UpdateBatch(**{k: jnp.asarray(v) for k, v in data.items()}), key)
    perms = np.stack([np.asarray(jnp.argsort(jax.random.uniform(k, (t_len, b)), axis=0))
                      for k in jax.random.split(key, cfg["n_epochs"])])
    variables = jax.tree.map(np.asarray, {"params": js.params, "batch_stats": js.batch_stats})
    torch.save({"variables": variables, "data": data, "perms": perms}, path)
    return {"variables": jax.tree.map(np.asarray, {"params": params, "batch_stats": stats}),
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dp2")
    want = jax_update_inputs(outdir / "update_inputs.pt")
    return run_workers(2, outdir, "td,td4x6,ppo,ppo_update"), want


def test_two_process_td_replicas_equal_the_ranks_in_turn(two_ranks):
    results, _ = two_ranks
    for mode in ("td", "td4x6"):
        want = in_process_td(mode, 2)
        for r, res in enumerate(results):
            assert_td_states_equal(res[mode]["state"], want, f"{mode}, rank {r}")
        assert results[0][mode]["episodes"] == results[1][mode]["episodes"]
    assert not torch.equal(results[0]["td"]["state"]["table"],
                           td.TDTrainer(td.TDConfig(**torch_dp_worker.TD_CONFIGS["td"]),
                                        "cpu").init_state()["table"])


def test_two_process_ppo_is_the_single_process_iteration(two_ranks):
    from gym2048_tpu_torch.utils.debug import trajectory_fingerprint

    results, _ = two_ranks
    a, b = (res["ppo"] for res in results)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert a["metrics"] == b["metrics"]
    for x, y in zip(a["rollout"], b["rollout"]):
        assert torch.equal(x, y)
    trainer = ppo.PPO(ppo.PPOConfig(**torch_dp_worker.PPO_CONFIG), device="cpu")
    state = trainer.init_state()
    seen = []
    collect = trainer._collect_rollout
    trainer._collect_rollout = lambda s: seen.append(collect(s)) or seen[-1]
    state, metrics = trainer.train_iteration(state)
    traj = seen[0][0]
    for got, want in zip(a["rollout"], (traj.board, traj.reward, traj.done)):
        assert torch.equal(got, want)
    assert trajectory_fingerprint(*a["rollout"]) == trajectory_fingerprint(
        traj.board, traj.reward, traj.done)
    for k, v in metrics.items():
        assert abs(a["metrics"][k] - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    for k, v in state.model.state_dict().items():
        scale = max(1.0, float(v.float().abs().max()))
        assert float((a["params"][k].float() - v.float()).abs().max()) <= 1e-5 * scale, k


def test_two_process_ppo_update_matches_jax(two_ranks):
    results, want = two_ranks
    a, b = (res["ppo_update"] for res in results)
    for x, y in zip(jax.tree.leaves(a["variables"]), jax.tree.leaves(b["variables"])):
        np.testing.assert_array_equal(x, y)
    cfg = torch_dp_worker.PPO_UPDATE_CONFIG
    steps = cfg["n_epochs"] * cfg["n_envs"] * cfg["n_steps"] // cfg["batch_size"]
    lr = ppo.PPOConfig().lr
    diffs = np.concatenate([np.abs(w - g).ravel() for w, g in zip(
        jax.tree.leaves(want["variables"]["params"]), jax.tree.leaves(a["variables"]["params"]),
        strict=True)])
    assert diffs.max() <= 0.1 * lr * steps, diffs.max() / lr
    assert np.median(diffs) <= 1e-3 * lr
    for w, g in zip(jax.tree.leaves(want["variables"]["batch_stats"]),
                    jax.tree.leaves(a["variables"]["batch_stats"]), strict=True):
        assert np.abs(w - g).max() <= 1e-5 * max(1.0, np.abs(w).max())
    for k in ppo._AUX:
        assert abs(a["metrics"][k] - want["metrics"][k]) <= 1e-4 * max(
            1.0, abs(want["metrics"][k])), k


def test_four_process_td_replicas(tmp_path):
    results = run_workers(4, tmp_path, "td,td4x6")
    for mode in ("td", "td4x6"):
        for res in results[1:]:
            assert_td_states_equal(res[mode]["state"], results[0][mode]["state"], mode)
    # alpha 0 and dyadic TC sums: exact in any order, so the in-process ranks agree
    want = in_process_td("td4x6", 4)
    assert_td_states_equal(results[0]["td4x6"]["state"], want, "td4x6 at 4 ranks")


def test_td_cli_sharded_then_resume(tmp_path):
    common = ["--envs", "16", "--chunk-steps", "4", "--alpha", "0.5", "--alpha-final", "0.25",
              "--init-value", "100", "--eval-episodes", "2", "--device", "cpu",
              "--ckpt", "ckpt.pkl", "--ckpt-every", "1"]
    outs = run_cli("gym2048_tpu_torch.train.td", common + ["--steps", "128", "--sharded"],
                   2, tmp_path)
    res = json.loads(outs[0].strip().splitlines()[-1])
    assert res["steps"] == 128 and res["output"] == "ntuple_table.pkl"
    assert "Average score" not in outs[1]  # rank 1 neither evaluates nor logs
    state, meta = td.load_train_state(tmp_path / "ckpt.pkl", "cpu")
    assert meta["chunks_done"] == 2 and state["boards"].shape == (16, 4, 4)
    # the checkpoint is the ranks-in-turn state: rank 1's envs collected into it
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=4, alpha=0.5, alpha_final=0.25,
                                  init_value=100.0, total_steps=128), "cpu")
    whole = tr.init_state()
    states = [td.shard_td_state(clone_state(whole), rank_mesh(2, r)) for r in range(2)]
    for c in range(2):
        states = [s for s, _ in ranks_in_turn(tr, states, 0.5 + (0.25 - 0.5) * c)]
    for k in td._BATCH_KEYS:
        assert_bits(state[k], torch.cat([s[k] for s in states]).numpy(), k)
    assert_bits(state["table"], states[0]["table"].numpy(), "table")
    outs = run_cli("gym2048_tpu_torch.train.td",
                   common + ["--steps", "192", "--resume", "ckpt.pkl"], 1, tmp_path)
    assert "resumed full train state at chunk 2" in outs[0]
    assert json.loads(outs[0].strip().splitlines()[-1])["steps"] == 192


def test_ppo_cli_mesh(tmp_path):
    args = ["--total-timesteps", "128", "--n-envs", "16", "--n-steps", "4", "--batch-size",
            "32", "--filters", "8", "--residual-blocks", "1", "--save-interval", "1",
            "--video-freq", "0", "--log-interval", "1", "--run-name", "m", "--device", "cpu",
            "--mesh"]
    outs = run_cli("gym2048_tpu_torch.tools.ppo", args, 2, tmp_path)
    assert "data-parallel training over mesh {'data': 2, 'model': 1}" in outs[0]
    assert "Training complete" in outs[0] and "Training complete" not in outs[1]
    from gym2048_tpu_torch.utils.checkpoint import Checkpointer

    ckpt = Checkpointer(tmp_path / "checkpoints")
    assert ckpt.all_steps() == [1, 2]
    saved = ckpt.restore(2)
    assert saved["env_state"]["board"].shape == (16, 4, 4) and saved["update_idx"] == 2
    assert len((tmp_path / "logs" / "m.jsonl").read_text().splitlines()) == 2
    # resumed from the checkpoint under 2 ranks: a third iteration
    outs = run_cli("gym2048_tpu_torch.tools.ppo", args[:1] + ["192"] + args[2:] + ["--resume"],
                   2, tmp_path)
    assert "Resumed from checkpoint step 2" in outs[0]
    assert ckpt.all_steps() == [1, 2, 3]

