"""The port's headline bench (``gym2048_tpu_torch/bench.py``) against the
repository's root ``bench.py`` on the CPU.

* Both ``main``s at the same tiny sizes (``BATCH``, ``T_SMALL``, ``T_LARGE``
  and ``SAMPLES`` patched in both modules) print one JSON line with the same
  keys, top level and ``detail``, and the same nulls.
* The configs that ``bench_td``, ``bench_td_big`` and both ``bench_ppo``
  shapes build equal JAX's field by field (captured by patching the trainer
  classes each bench constructs; JAX's dtypes mapped by name), with the
  same alphas; under a clock that advances one second a call, every rate
  (``bench_xla`` and ``bench_pallas`` too) is the work it counts, equal in
  both.
* The random-legal rollout takes only legal moves, and its episode length
  and score per step lie in ``chip_smoke.py`` phase 9's random-play band,
  as do JAX's rollout's (``bench.py``'s loop body) at the same size: the two
  draw different numbers, so statistics are compared, not boards.
* ``main`` exits 1 on a ratio outside [0.8, 3.0] and on each floor.
"""

import dataclasses
import itertools
import json
import time

import bench as jbench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym2048_tpu.core.pallas_step as jpallas_step
import gym2048_tpu.train as jtrain
from gym2048_tpu.env import EnvConfig
from gym2048_tpu.env import batched as jbatched
from gym2048_tpu.train import td as jtd
from gym2048_tpu_torch import bench
from gym2048_tpu_torch.core import fused_step
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.train import ppo, td

TINY = {"BATCH": 16, "T_SMALL": 2, "T_LARGE": 4, "SAMPLES": 2}
# chip_smoke.py phase 9: random play's episode length and score per step
EP_LEN_BAND, SCORE_PER_STEP_BAND = (100.0, 150.0), (8.0, 10.5)
STATS_BOARDS, STATS_STEPS = 256, 512


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch):
    for name, value in TINY.items():
        monkeypatch.setattr(jbench, name, value)
        monkeypatch.setattr(bench, name, value)


def printed_line(main, capsys) -> dict:
    capsys.readouterr()
    main()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_main_line_has_the_keys_and_nulls_of_jax(tiny, capsys):
    want = printed_line(jbench.main, capsys)
    got = printed_line(lambda: bench.main(["--device", "cpu"]), capsys)
    assert set(got) == set(want)
    assert set(got["detail"]) == set(want["detail"])
    for line in (got, got["detail"]):
        ref = want if line is got else want["detail"]
        assert {k for k, v in line.items() if v is None} == {
            k for k, v in ref.items() if v is None}
    assert got["detail"]["device"] == "cpu"
    assert got["value"] == got["detail"]["xla_steps_per_s"]
    assert got["detail"]["xla_batch"] == TINY["BATCH"]
    assert got["detail"]["scan_len"] == TINY["T_LARGE"]


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else \
        np.dtype(dtype).name


def fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    if "compute_dtype" in out:
        out["compute_dtype"] = dtype_name(out["compute_dtype"])
    return out


class FakeTrainers:
    """Stand-ins for the TD and PPO trainers that record each config and
    the alphas and return at once."""

    def __init__(self):
        self.configs, self.alphas = [], []
        rec = self

        class TD:
            def __init__(self, cfg, device=None):
                rec.configs.append(cfg)

            def init_state(self, *args):
                return {}

            def train_chunk(self, state, alpha):
                rec.alphas.append(np.float32(alpha))
                return state, {"episodes": np.float32(0.0)}

        class PPO:
            def __init__(self, cfg, device=None, mesh=None):
                rec.configs.append(cfg)

            def init_state(self, *args):
                return None

            def train_iteration(self, state):
                return state, {"loss": np.float32(0.0)}

        self.TD, self.PPO = TD, PPO


@pytest.fixture
def one_second_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


def test_learner_configs_and_work_equal_jax(monkeypatch, one_second_clock):
    want, got = FakeTrainers(), FakeTrainers()
    monkeypatch.setattr(jtd, "TDTrainer", want.TD)
    monkeypatch.setattr(jtrain, "PPO", want.PPO)
    monkeypatch.setattr(td, "TDTrainer", got.TD)
    monkeypatch.setattr(ppo, "PPO", got.PPO)
    cpu = torch.device("cpu")
    rates = [(jbench.bench_td(), bench.bench_td(cpu)),
             (jbench.bench_td_big(), bench.bench_td_big(cpu)),
             (jbench.bench_ppo(False), bench.bench_ppo(False, cpu)),
             (jbench.bench_ppo(True), bench.bench_ppo(True, cpu))]
    assert len(got.configs) == len(want.configs) == 4
    for g, w in zip(got.configs, want.configs):
        assert fields(g) == fields(w)
    assert fields(got.configs[2])["compute_dtype"] == "bfloat16"
    assert got.alphas == want.alphas
    work = [8192 * 64, 8192 * 16, 4096 * 128, 8 * 2048]
    assert rates == [(w, w) for w in work]


def test_env_rates_count_the_same_work(tiny, monkeypatch, one_second_clock):
    monkeypatch.setattr(jpallas_step, "fused_rollout",
                        lambda cm, *args: (cm, np.zeros(1, np.float32)))
    monkeypatch.setattr(fused_step, "fused_rollout",
                        lambda cm, *args: (cm, torch.zeros(1)))
    cpu = torch.device("cpu")
    xla = bench.bench_xla(cpu)
    assert xla == jbench.bench_xla()
    assert xla[0] == TINY["BATCH"] * TINY["T_LARGE"]
    pallas = bench.bench_pallas(cpu)
    assert pallas == jbench.bench_pallas()
    assert pallas[0] == bench.PALLAS_BATCH * bench.T_LARGE


def statistics(illegal: int, terminated: int, reward: float) -> tuple[float, float]:
    """(steps per finished episode, score per step) of a rollout, which
    must have made no illegal move."""
    assert illegal == 0
    steps = STATS_BOARDS * STATS_STEPS
    return steps / max(terminated, 1), reward / steps


def in_band(stats) -> bool:
    (ep_len, per_step) = stats
    return (EP_LEN_BAND[0] < ep_len < EP_LEN_BAND[1]
            and SCORE_PER_STEP_BAND[0] < per_step < SCORE_PER_STEP_BAND[1])


def test_random_legal_rollout_statistics():
    gen = torch.Generator().manual_seed(0)
    state = batched.reset(gen, STATS_BOARDS, device="cpu")
    illegal = terminated = 0
    reward = 0.0
    for _ in range(STATS_STEPS):
        state, ts = bench.random_legal_step(state, gen)
        illegal += int(ts.illegal.sum())
        terminated += int(ts.terminated.sum())
        reward += float(ts.reward.double().sum())
    got = statistics(illegal, terminated, reward)

    cfg = EnvConfig(auto_reset=True)

    @jax.jit
    def jax_rollout(state):
        def body(state, _):  # bench.py::build_rollout's body
            key = jax.random.fold_in(state.key, 1)
            mask = jbatched.legal_actions(state)
            act = jax.random.categorical(key, jnp.where(mask, 0.0, -1e9), axis=-1)
            state, ts = jbatched.step(state, act, cfg)
            return state, (ts.illegal.sum(), ts.terminated.sum(), ts.reward.sum())

        return jax.lax.scan(body, state, None, length=STATS_STEPS)[1]

    ill, term, rew = jax_rollout(jbatched.reset(jax.random.PRNGKey(0), STATS_BOARDS))
    want = statistics(int(ill.sum()), int(term.sum()), float(np.asarray(rew, np.float64).sum()))
    assert in_band(got), got
    assert in_band(want), want


@pytest.fixture
def fake_card(monkeypatch):
    """``main`` on a pretend card: every rate 200 (the headline 1e9), every
    floor 100, the ratio 1; returns the dict of values to change."""
    values = {"ratio": 1.0, "td": 200.0, "td_big": 200.0, "ppo_prod": 200.0, "ppo_ref": 200.0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "device_name", lambda device: "a card, 700.00 W")
    monkeypatch.setattr(bench, "bench_xla", lambda d: (1e6, [1e6, 1e6], values["ratio"]))
    monkeypatch.setattr(bench, "bench_pallas", lambda d: (1e9, [1e9, 1e9]))
    monkeypatch.setattr(bench, "bench_td", lambda d: values["td"])
    monkeypatch.setattr(bench, "bench_td_big", lambda d: values["td_big"])
    monkeypatch.setattr(bench, "bench_ppo",
                        lambda reference, d: values["ppo_ref" if reference else "ppo_prod"])
    for floor in ("TD_FLOOR", "TD_BIG_FLOOR", "PPO_PROD_FLOOR", "PPO_REF_FLOOR"):
        monkeypatch.setattr(bench, floor, 100)
    return values


def test_main_on_the_card_passes(fake_card, capsys):
    assert bench.main([]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["value"] == 1e9 and line["vs_baseline"] == 10.0
    assert line["detail"]["scaling_check_ok"] is True
    assert line["detail"]["device"] == "a card, 700.00 W"
    assert None not in line["detail"].values()


@pytest.mark.parametrize("change", [("ratio", 0.79), ("ratio", 3.01), ("td", 99.0),
                                    ("td_big", 99.0), ("ppo_prod", 99.0), ("ppo_ref", 99.0)])
def test_main_fails_on_the_ratio_and_each_floor(fake_card, capsys, change):
    key, value = change
    fake_card[key] = value
    assert bench.main([]) == 1
    out, err = capsys.readouterr()
    assert len(out.splitlines()) == 1 and err.startswith("FAIL:")


def test_main_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
