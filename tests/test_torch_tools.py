"""The port's CLIs (gym2048_tpu_torch.tools) on the CPU at tiny sizes,
against the JAX package's CLIs and files.

* selfplay: the invariants of ``tests/test_tools.py``, the host
  post-processing on hand-made arrays, and random play's score against
  JAX's (within 4 standard errors: each package draws its own numbers);
* model files cross over: a port ``pretrain_bc`` pickle runs in the JAX
  package's ``ActorCritic.apply`` within 1e-5 (f32 roundoff of the forward,
  tests/test_torch_resnet.py), and a JAX ``pretrain_bc`` pickle starts the
  port's ``ppo --pretrained``;
* ``ppo --save-interval`` then ``--resume`` equals a straight run bit for
  bit; ``--mesh`` names its queue item; ``--video-freq`` writes a GIF;
* ``evaluate`` writes the JAX CLI's ``scores_<label>.csv`` on the same
  pickle and seeds (the reference protocol; the forward's roundoff does
  not flip an argmax on these episodes);
* ``train`` prints JAX's sample counts under one ``np.random.seed``;
* each CSV tool's output is byte-identical to the JAX tool's;
* ``chip_smoke.py``'s phase-20 checks (``check_transitions``,
  ``checkpoint_diffs``) pass good data and catch planted faults.
"""

import os
import pickle
import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gym2048_tpu.data import TrainingData as JTrainingData
from gym2048_tpu_torch.data import TrainingData
from gym2048_tpu_torch.tools import (
    add_rewards,
    augment_data,
    distribute_data,
    evaluate,
    hflip_data,
    merge_data,
    ppo,
    pretrain_bc,
    selfplay,
    train,
)
from gym2048_tpu_torch.utils.checkpoint import Checkpointer, load_model

CPU = ["--device", "cpu"]
TINY = ["--filters", "8", "--residual-blocks", "1"]
PPO_TINY = ["--total-timesteps", "256", "--n-envs", "16", "--n-steps", "8", "--batch-size", "32",
            "--n-epochs", "1", *TINY, "--log-interval", "1", *CPU]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contend with each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """TensorBoard is optional; its import takes seconds here."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def small_csv(tmp_path_factory):
    """A self-play dataset from the port (random-legal policy)."""
    path = tmp_path_factory.mktemp("data") / "selfplay.csv"
    td = selfplay.generate(600, batch=64, seed=0, device="cpu")
    td.export_csv(path)
    assert td.size() == 640
    return str(path)


# ---------------------------------------------------------------- selfplay

def test_selfplay_rows_are_legal_moves_in_game_order(small_csv):
    from gym2048_tpu_torch.core import rules_np

    td = TrainingData()
    td.import_csv(small_csv)
    x, nx, a = td.get_x(), td.get_next_x(), td.get_y_digit().reshape(-1)
    new, score, changed = rules_np.move_batch(x, a)
    assert changed.all()
    np.testing.assert_array_equal(td.get_reward().reshape(-1), score)
    spawn = nx - new
    assert ((spawn != 0).sum(axis=(1, 2)) == 1).all()
    assert np.isin(spawn.sum(axis=(1, 2)), (2, 4)).all()
    rows = x.reshape(64, 10, 4, 4)  # per-env order: 10 steps an env
    nexts = nx.reshape(64, 10, 4, 4)
    np.testing.assert_array_equal(rows[:, 1:], nexts[:, :-1])  # no game ends in 10 moves


def test_selfplay_done_rows_keep_the_terminal_board():
    td = selfplay.generate(3000, batch=16, seed=1, device="cpu")
    dones = td.get_done().reshape(-1)
    assert dones.any()
    assert ((td.get_next_x()[dones] > 0).sum(axis=(1, 2)) == 16).all()


def test_selfplay_cli_and_model_policy(small_csv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    selfplay.main(["-o", "out.csv", "-n", "200", "--batch", "32", *CPU])
    td = TrainingData()
    td.import_csv("out.csv")
    assert td.size() == 224
    pretrain_bc.main([small_csv, "--output", "bc", "--epochs", "1", *TINY, "--no-augment", *CPU])
    td = selfplay.generate(512, "model", "bc.pkl", batch=32, seed=2, epsilon=0.5, device="cpu")
    assert 0 < td.size() <= 512 and set(np.unique(td.get_y_digit())) <= {0, 1, 2, 3}


def test_postprocess_on_hand_made_arrays():
    """T=4 steps of B=2 envs. Env 0: rows 0-3 with an illegal move at t=2
    that ends its episode (its done moves back to t=1) and a legal move at
    t=3. Env 1: an illegal move at t=0 (nothing to move the done onto), a
    done at t=1, and two illegal moves at t=2-3 after it (the done at t=1
    is not moved again)."""
    t_len, b = 4, 2
    boards = np.zeros((t_len, b, 4, 4), np.int8)
    for t in range(t_len):
        for e in range(b):
            boards[t, e, 0, 0] = 10 * e + t + 1
    nexts = boards + 1
    actions = np.arange(t_len * b, dtype=np.int32).reshape(t_len, b) % 4
    rewards = np.arange(t_len * b, dtype=np.float32).reshape(t_len, b)
    illegal = np.zeros((t_len, b), bool)
    dones = np.zeros((t_len, b), bool)
    illegal[2, 0] = dones[2, 0] = True
    illegal[0, 1] = dones[0, 1] = True
    dones[1, 1] = True
    illegal[2, 1] = illegal[3, 1] = dones[3, 1] = True
    td = selfplay.postprocess(boards, actions, rewards, nexts, dones, illegal)
    # kept rows in per-env order: env 0 at t=0, 1, 3; env 1 at t=1
    want_t = [(0, 0), (1, 0), (3, 0), (1, 1)]
    exps = td.get_x_exponents()[:, 0, 0]
    assert exps.tolist() == [10 * e + t + 1 for t, e in want_t]
    assert td.get_done().reshape(-1).tolist() == [False, True, False, True]
    assert td.get_y_digit().reshape(-1).tolist() == [actions[t, e] for t, e in want_t]
    assert td.get_reward().reshape(-1).tolist() == [rewards[t, e] for t, e in want_t]
    next_exps = np.log2(np.maximum(td.get_next_x(), 1)).astype(int)[:, 0, 0]
    assert next_exps.tolist() == [10 * e + t + 2 for t, e in want_t]
    assert not dones[1, 0]  # the input is not modified


def game_scores(td, steps):
    """Scores of the complete games (from a reset to a done) of a
    per-env-ordered random rollout."""
    r = td.get_reward().reshape(-1, steps)
    d = td.get_done().reshape(-1, steps)
    out = []
    for env in range(len(r)):
        ends = [-1] + list(np.nonzero(d[env])[0])
        out += [r[env, a + 1:b + 1].sum() for a, b in zip(ends[:-1], ends[1:])]
    return np.array(out)


def test_random_play_scores_match_jax():
    from gym2048_tpu.tools import selfplay as jselfplay

    steps, batch = 400, 32
    ours = game_scores(selfplay.generate(steps * batch, batch=batch, seed=3, device="cpu"), steps)
    theirs = game_scores(jselfplay.generate(steps * batch, batch=batch, seed=3), steps)
    assert len(ours) > 60 and len(theirs) > 60
    se = np.sqrt(ours.var() / len(ours) + theirs.var() / len(theirs))
    assert abs(ours.mean() - theirs.mean()) < 4 * se, (ours.mean(), theirs.mean(), se)
    assert 600 < ours.mean() < 1600


# ------------------------------------------------------------ model files

def test_port_bc_pickle_runs_in_jax(small_csv, tmp_path, monkeypatch):
    import jax.numpy as jnp

    from gym2048_tpu.models import ActorCritic as JActorCritic
    from gym2048_tpu.models import boards_to_model_input as jinput
    from gym2048_tpu.utils.checkpoint import load_model as jload_model
    from gym2048_tpu_torch import interop
    from gym2048_tpu_torch.models.resnet import boards_to_model_input

    monkeypatch.chdir(tmp_path)
    pretrain_bc.main([small_csv, "--output", "bc", "--epochs", "1", *TINY, *CPU])
    variables, meta = jload_model("bc.pkl")
    assert meta == {"filters": 8, "residual_blocks": 1, "model": "ActorCritic"}
    rng = np.random.default_rng(0)
    b = np.where(rng.random((16, 4, 4)) < 0.4, 0, rng.integers(1, 12, (16, 4, 4))).astype(np.int8)
    want = JActorCritic(8, 1).apply(variables, jinput(jnp.asarray(b)), train=False)
    model = interop.resnet_from_variables(load_model("bc.pkl")[0], device="cpu")
    with torch.no_grad():
        got = model(boards_to_model_input(torch.from_numpy(b)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


def test_jax_bc_pickle_starts_port_ppo(small_csv, tmp_path, monkeypatch, capsys):
    from gym2048_tpu.tools import pretrain_bc as jpretrain_bc

    monkeypatch.chdir(tmp_path)
    jpretrain_bc.main([small_csv, "--output", "jbc", "--epochs", "1", *TINY, "--no-augment"])
    state = ppo.main([*PPO_TINY, "--pretrained", "jbc.pkl", "--save-interval", "0",
                      "--video-freq", "0", "--run-name", "j", "--total-timesteps", "128"])
    assert "Loaded pre-trained policy weights from jbc.pkl" in capsys.readouterr().out
    assert state.update_idx == 1 and os.path.exists("logs/j.jsonl")
    # a Game2048Model file is refused
    with open("g.pkl", "wb") as f:
        pickle.dump({"variables": {}, "meta": {"model": "Game2048Model"}}, f)
    with pytest.raises(ValueError, match="ActorCritic"):
        ppo.main([*PPO_TINY, "--pretrained", "g.pkl", "--save-interval", "0"])


# --------------------------------------------------------------------- ppo

def test_ppo_resume_equals_a_straight_run(tmp_path, monkeypatch):
    """Three iterations straight, against two with a checkpoint each and
    ``--resume`` to the third: checkpoint 3 (the whole state) equal bit for
    bit. (With ``--anneal-lr`` the schedule spans ``--total-timesteps``, so
    a run that is extended on resume follows another schedule, in JAX too.)"""
    common = [*PPO_TINY, "--save-interval", "1", "--video-freq", "0", "--run-name", "r",
              "--mask-illegal"]
    (tmp_path / "straight").mkdir()
    monkeypatch.chdir(tmp_path / "straight")
    straight = ppo.main(common + ["--total-timesteps", "384"])
    (tmp_path / "resumed").mkdir()
    monkeypatch.chdir(tmp_path / "resumed")
    ppo.main(common + ["--total-timesteps", "256"])
    assert Checkpointer("checkpoints").all_steps() == [1, 2]
    resumed = ppo.main(common + ["--total-timesteps", "384", "--resume"])
    assert straight.update_idx == resumed.update_idx == 3
    a = Checkpointer(tmp_path / "straight" / "checkpoints").restore(3)
    b = Checkpointer(tmp_path / "resumed" / "checkpoints").restore(3)
    assert chip_smoke.checkpoint_diffs(a, b) == []
    assert a["update_idx"] == 3 and a["optimizer"]["state_dict"]["count"] == 3 * 4
    assert len(open("logs/r.jsonl").read().splitlines()) == 3


def test_ppo_mesh_runs_on_one_rank(tmp_path, monkeypatch):
    """``--mesh`` with no coordinator: a warning, one rank, the sharded
    shuffle forced; the state is the one-process learner's of that config
    bit for bit (data parallel over real ranks: tests/test_torch_parallel.py)."""
    from gym2048_tpu_torch.train import ppo as ppo_learner

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="no coordinator configured"):
        state = ppo.main([*PPO_TINY, "--total-timesteps", "128", "--save-interval", "1",
                          "--video-freq", "0", "--run-name", "m", "--mesh"])
    assert state.update_idx == 1 and Checkpointer("checkpoints").all_steps() == [1]
    trainer = ppo_learner.PPO(ppo_learner.PPOConfig(
        total_timesteps=128, n_envs=16, n_steps=8, batch_size=32, n_epochs=1, filters=8,
        residual_blocks=1, shuffle_mode="sharded"), device="cpu")
    want, _ = trainer.train_iteration(trainer.init_state())
    got, ref = state.model.state_dict(), want.model.state_dict()
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_ppo_video_freq_writes_a_gif(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ppo.main([*PPO_TINY, "--total-timesteps", "128", "--save-interval", "0", "--video-freq",
              "100", "--run-name", "v"])
    gif = tmp_path / "videos" / "v_128.gif"
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a")


def test_record_episode_gif(tmp_path):
    import random

    from gym2048_tpu_torch.utils.video import record_episode_gif

    random.seed(0)
    stats = record_episode_gif(lambda obs: random.randrange(4), tmp_path / "ep.gif", seed=3,
                               max_steps=50)
    assert os.path.exists(stats["path"]) and stats["frames"] == stats["steps"] + 1


# --------------------------------------------------------- evaluate, train

def test_evaluate_writes_the_jax_clis_scores(small_csv, tmp_path, monkeypatch):
    from gym2048_tpu.tools import evaluate as jevaluate

    monkeypatch.chdir(tmp_path)
    pretrain_bc.main([small_csv, "--output", "bc", "--epochs", "1", *TINY, "--no-augment", *CPU])
    evaluate.main(["bc.pkl", "--episodes", "4", "--epsilon", "0.1", "--label", "port", *CPU])
    jevaluate.main(["bc.pkl", "--episodes", "4", "--epsilon", "0.1", "--label", "jax"])
    port = open("scores_port.csv").read()
    assert port == open("scores_jax.csv").read()
    assert len(port.splitlines()) == 5
    evaluate.main(["bc.pkl", "--episodes", "8", "--fast", "--mask-illegal", "--label", "fast",
                   *CPU])
    lines = open("scores_fast.csv").read().splitlines()
    assert len(lines) == 9 and all(line.endswith(",0") for line in lines[1:])


def test_train_counts_match_jax(small_csv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    np.random.seed(4)
    val = train.main([small_csv, "--epochs", "1", *TINY, "--eval-episodes", "2", *CPU])
    out = capsys.readouterr().out
    got = tuple(int(x) for x in re.search(r"(\d+) training / (\d+) validation", out).groups())
    np.random.seed(4)
    data = JTrainingData()
    data.import_csv(small_csv)
    data.shuffle()
    training, validation = data.split(0.8)
    training.augment()
    training.make_boards_unique()
    assert got == (training.size(), validation.size())
    assert 0.0 <= val["accuracy"] <= 1.0 and np.isfinite(val["loss"])
    for name in ("model.pkl", "scores_pretraining.csv", "scores_trained.csv"):
        assert os.path.exists(name)
    assert load_model("model.pkl")[1]["model"] == "Game2048Model"
    train.main([small_csv, "--epochs", "1", *TINY, "--eval-episodes", "4", "--fast-eval",
                "--output-model", "fast.pkl", *CPU])
    assert len(open("scores_trained.csv").read().splitlines()) == 5


# ---------------------------------------------------------------- CSV tools

CSV_TOOLS = {
    "merge_data": (["--min-high-tile", "4", "{csv}", "{csv}"], "merge_data"),
    "augment_data": (["{csv}"], "augment_data"),
    "hflip_data": (["{csv}"], "hflip_data"),
    "distribute_data": (["{csv}"], "distribute_data"),
    "add_rewards": (["{csv}"], "add_rewards"),
}


@pytest.mark.parametrize("tool", sorted(CSV_TOOLS))
def test_csv_tool_output_equals_the_jax_tools(small_csv, tmp_path, tool):
    import importlib

    args, name = CSV_TOOLS[tool]
    args = [a.format(csv=small_csv) for a in args]
    port = {"merge_data": merge_data, "augment_data": augment_data, "hflip_data": hflip_data,
            "distribute_data": distribute_data, "add_rewards": add_rewards}[tool]
    jax_tool = importlib.import_module(f"gym2048_tpu.tools.{name}")
    port.main(["-o", str(tmp_path / "port.csv"), *args])
    jax_tool.main(["-o", str(tmp_path / "jax.csv"), *args])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert os.path.getsize(tmp_path / "port.csv") > 1000


def test_merge_rejects_low_tiles(small_csv, tmp_path, capsys):
    merge_data.main(["-o", str(tmp_path / "m.csv"), "--min-high-tile", "65536", small_csv])
    assert "Rejecting" in capsys.readouterr().out


# ------------------------------------------------- chip_smoke's shell checks

def test_chip_smoke_transition_check_catches_faults():
    """``chip_smoke.check_transitions`` (phase 20b) passes a real rollout
    and fails on a wrong reward, a second spawned tile or a broken episode."""
    td = selfplay.generate(2048, batch=8, seed=6, device="cpu")
    rows, dones = chip_smoke.check_transitions(td, 256)
    assert rows == 2048 and dones > 0
    for field, row, change in (("_reward", 5, 2.0), ("_next_x", 9, None), ("_x", 20, None)):
        bad = td.copy()
        arr = getattr(bad, field)
        if change is not None:
            arr[row] += change
        else:
            cell = np.argwhere(arr[row] == 0)[0]
            arr[row][tuple(cell)] = 2
        with pytest.raises(RuntimeError, match="check failed"):
            chip_smoke.check_transitions(bad, 256)
    best_acc, best_loss = chip_smoke.legal_chance(td.get_x())
    assert 0.25 <= best_acc <= 1.0 and 0.0 <= best_loss <= np.log(4)


def test_chip_smoke_state_diffs():
    from gym2048_tpu_torch.train import ppo as tppo

    cfg = tppo.PPOConfig(n_envs=4, n_steps=2, batch_size=8, n_epochs=1, filters=4,
                         residual_blocks=1)
    tr = tppo.PPO(cfg, device="cpu")
    a, b = tr.init_state(), tr.init_state()
    assert chip_smoke.checkpoint_diffs(a, b) == []
    torch.rand(1, generator=b.generator)
    with torch.no_grad():
        b.model.value_head.bias.add_(1.0)
    assert chip_smoke.checkpoint_diffs(a, b) == ["state.model.state_dict.value_head.bias",
                                                "state.generator.generator_state"]
