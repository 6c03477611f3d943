"""PPO's rollout on static buffers (``train/ppo.py::_RolloutGraph``), which on
a CUDA device with one rank is one CUDA graph replay a step: the moves, the
policy in eval mode, the mask, the Gumbel-max, the logprob, the env step and
the trajectory's writes at a device index, on uniforms drawn into the
buffers before each step. Off the card every step is a plain call of the
same code on the same buffers, so these tests hold the buffers' data flow on
the CPU against the rollout written out op by op
(``chip_smoke.reference_rollout``): bit for bit over successive rollouts
(every trajectory field, the last values, the env state and the generator),
the returned tensors untouched by later rollouts, the holder rebuilt when
what a capture fixes changes, the spans and counters, and where a graph is
captured. The capture itself runs only on the card (``chip_smoke.py`` phase
19g)."""

import dataclasses
import functools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gym2048_tpu_torch.train import ppo
from gym2048_tpu_torch.utils import graphs, profiler

TINY = dict(total_timesteps=3 * 64, n_envs=8, n_steps=8, batch_size=16, n_epochs=2,
            filters=8, residual_blocks=1, seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trainer(graph: bool, **kw) -> ppo.PPO:
    """A learner whose rollout is its own (``graph``) or the reference."""
    tr = ppo.PPO(ppo.PPOConfig(**{**TINY, **kw}), device="cpu")
    if not graph:
        tr._collect_rollout = functools.partial(chip_smoke.reference_rollout, tr)
    return tr


def rollouts(tr: ppo.PPO, state: ppo.TrainState, n: int) -> list[tuple]:
    """``n`` successive rollouts: each one's returned tensors (the
    trajectory's fields, then the last values) and its env state after it,
    as returned, and a copy of both taken then."""
    out = []
    for _ in range(n):
        traj, last_value = tr._collect_rollout(state)
        got = (*traj.tensors(), last_value, *ppo._env_tensors(state.env_state))
        out.append((got, tuple(x.clone() for x in got)))
    return out


def assert_equal(xs, ys) -> None:
    assert len(xs) == len(ys)
    for k, (x, y) in enumerate(zip(xs, ys)):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("mask_illegal", [False, True])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_graphed_rollouts_equal_eager(mask_illegal, compute_dtype):
    """Two successive rollouts on the holder's buffers and written out op
    by op from one seed: every trajectory field, the last values, the env
    state after each and the generator's state after both equal bit for
    bit; the holder was built once and captured nothing."""
    kw = dict(mask_illegal=mask_illegal, compute_dtype=compute_dtype)
    eager, graphed = trainer(False, **kw), trainer(True, **kw)
    a, b = eager.init_state(), graphed.init_state()
    ra, rb = rollouts(eager, a, 2), rollouts(graphed, b, 2)
    for (_, x), (_, y) in zip(ra, rb):
        assert_equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert eager._rollout_graph is None
    holder = graphed._rollout_graph
    assert not holder.graphed.captures and holder.graphed.graph is None


@pytest.mark.parametrize("shuffle_mode", ["global", "sharded"])
def test_iterations_with_the_graphed_rollout_equal_eager(shuffle_mode):
    """Two whole ``train_iteration``s with the buffered rollout and with the
    one written out op by op from one seed end in the same parameters,
    BatchNorm statistics, Adam state, envs and generator, bit for bit."""
    states = []
    for graph in (False, True):
        tr = trainer(graph, shuffle_mode=shuffle_mode, mask_illegal=True)
        state = tr.init_state()
        for _ in range(2):
            state, _ = tr.train_iteration(state)
        states.append(state)
    a, b = states
    ma, mb = a.model.state_dict(), b.model.state_dict()
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    oa, ob = a.optimizer.state_dict()["adam"]["state"], b.optimizer.state_dict()["adam"]["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert_equal(ppo._env_tensors(a.env_state), ppo._env_tensors(b.env_state))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_returned_rollout_outlives_the_next():
    """A rollout's trajectory, last values and env state are tensors of their
    own, none of them the holder's buffers, unchanged by the next rollout
    (the benchmark keeps two rollouts and their next boards)."""
    tr = trainer(True)
    state = tr.init_state()
    (first, snap), (second, _) = rollouts(tr, state, 2)
    assert_equal(first, snap)
    holder = tr._rollout_graph
    buffers = {x.data_ptr() for x in (*holder.traj.tensors(), *ppo._env_tensors(holder.env))}
    returned = [x.data_ptr() for x in (*first, *second)]
    assert not buffers & set(returned) and len(set(returned)) == len(returned)
    assert not torch.equal(first[0], second[0])  # the second rollout went on


def test_each_rollout_starts_from_the_states_envs():
    """Envs put into the state between rollouts (a reset, a restored
    checkpoint) are the ones the next buffered rollout steps, as the
    reference's."""
    runs = []
    for graph in (False, True):
        tr = trainer(graph)
        state = tr.init_state()
        got = rollouts(tr, state, 1)
        state.env_state = ppo.batched.reset(state.generator, TINY["n_envs"], device="cpu")
        runs.append(got + rollouts(tr, state, 1))
    for (_, x), (_, y) in zip(*runs):
        assert_equal(x, y)


def _new_model(tr: ppo.PPO, state: ppo.TrainState) -> ppo.PPO:
    """Another model (a fresh one of the same weights) in ``state``."""
    fresh = tr.init_state(torch.Generator().manual_seed(0)).model
    fresh.load_state_dict(state.model.state_dict())
    state.model = fresh
    return tr


def _new_config(**kw):
    def change(tr: ppo.PPO, state: ppo.TrainState) -> ppo.PPO:
        """``tr`` with a config changed in ``kw`` (its envs: as many more
        boards, the state's own again)."""
        tr.cfg = dataclasses.replace(tr.cfg, **kw)
        if "n_envs" in kw:
            tr.n_local = tr.cfg.n_envs
            extra = ppo.batched.reset(state.generator, kw["n_envs"] - TINY["n_envs"],
                                      device="cpu")
            state.env_state = ppo.batched.EnvState(*(
                torch.cat([x, y]) for x, y in zip(ppo._env_tensors(state.env_state),
                                                  ppo._env_tensors(extra))))
        return tr
    return change


@pytest.mark.parametrize("change", [_new_config(n_envs=16), _new_config(
    compute_dtype=torch.bfloat16), _new_model], ids=["n_envs", "compute_dtype", "model"])
def test_a_new_shape_dtype_or_model_rebuilds_the_holder(change):
    """After one rollout, a change of the envs, the policy's precision or the
    model makes the next rollout build a new holder; the rollouts still
    equal the reference's doing the same."""
    runs = []
    for graph in (False, True):
        tr = trainer(graph)
        state = tr.init_state()
        got = rollouts(tr, state, 1)
        first = tr._rollout_graph
        got += rollouts(change(tr, state), state, 1)
        if graph:
            holder = tr._rollout_graph
            assert holder is not first
            assert holder.key == ppo._RolloutGraph.key_of(tr, state) != first.key
        runs.append(got)
    for (_, x), (_, y) in zip(*runs):
        assert_equal(x, y)


@pytest.mark.parametrize("n_rollouts", [1, 2])
def test_spans_and_counters(n_rollouts):
    """Each rollout step runs in ``ppo.env``, and ``ppo.policy`` holds each
    step's policy (with its draw of the action's uniforms) and the last
    value forward, on the holder's first steps as on its later ones. Off
    the card no step is a replay and the holder can capture none, so
    neither ``ppo.rollout_replays`` nor ``ppo.rollout_steps`` counts."""
    tr = trainer(True)
    state = tr.init_state()
    n = TINY["n_steps"]
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n_rollouts):
                tr._collect_rollout(state)
        summary = profiler.summary()
    finally:
        profiler.clear()
    assert summary["counters"] == {}
    spans = {name: s["calls"] for name, s in summary["spans"].items()}
    assert spans == {"ppo.env": n * n_rollouts, "ppo.policy": (n + 1) * n_rollouts}


def test_graphed_by_default_on_one_card_only(monkeypatch):
    """A step is captured on a CUDA device alone, and the rollout's holder
    hands its learner's device to :class:`graphs.GraphedStep` only with one
    rank (data parallel steps eagerly)."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: ("side", device))
    assert graphs.GraphedStep(None, "c", torch.device("cuda")).captures
    assert not graphs.GraphedStep(None, "c", torch.device("cpu")).captures
    assert not graphs.GraphedStep(None, "c", None).captures

    devices = []
    real = graphs.GraphedStep

    def record(run, counter, device):
        devices.append(device)
        return real(run, counter, device)

    monkeypatch.setattr(graphs, "GraphedStep", record)
    tr = trainer(True)
    state = tr.init_state()
    ppo._RolloutGraph(ppo._RolloutGraph.key_of(tr, state), tr, state)
    tr.group = object()  # a rank of a mesh
    ppo._RolloutGraph(ppo._RolloutGraph.key_of(tr, state), tr, state)
    assert devices == [torch.device("cpu"), None]
