"""PPO's SGD step on static buffers (``train/ppo.py::_SgdGraph``), which on
a CUDA device with one rank is one CUDA graph replay a step: the forward,
the masked loss, the backward, the clip and Adam (``Optimizer.apply``, the
update in foreach ops on Adam's own state). Off the card a replay is a
plain call of the same code on the same buffers, so these tests set
``graph_sgd`` on the CPU and hold the buffers' data flow: bit for bit
against the eager step over whole iterations (per-step metrics, every
parameter, BatchNorm's running statistics, Adam's moments and counts), the
returned metrics untouched by later steps, the holder rebuilt when the
optimiser's state is loaded, checkpoints crossing between the two paths,
and the spans and counters. The capture itself runs only on the card
(``chip_smoke.py`` phase 19f)."""

import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gym2048_tpu_torch.train import ppo
from gym2048_tpu_torch.utils import checkpoint as tck
from gym2048_tpu_torch.utils import graphs, profiler

# 8 SGD steps an iteration (2 epochs of 4 minibatches); both shuffles allowed
TINY = dict(total_timesteps=3 * 64, n_envs=8, n_steps=8, batch_size=16, n_epochs=2,
            filters=8, residual_blocks=1, seed=3)
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trainer(graph: bool, **kw) -> ppo.PPO:
    tr = ppo.PPO(ppo.PPOConfig(**{**TINY, **kw}), device="cpu")
    tr.graph_sgd = graph
    return tr


def keep_steps(tr: ppo.PPO) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Make ``tr`` keep each SGD step's returned metrics and a copy taken
    when they were returned."""
    kept, step = [], tr._sgd_step

    def keep(state, mb):
        aux = step(state, mb)
        kept.append((aux, aux.clone()))
        return aux

    tr._sgd_step = keep
    return kept


def iterations(tr: ppo.PPO, state: ppo.TrainState, n: int) -> ppo.TrainState:
    for _ in range(n):
        state, _ = tr.train_iteration(state)
    return state


def assert_same_state(a: ppo.TrainState, b: ppo.TrainState) -> None:
    """Every parameter and BatchNorm statistic, Adam's moments, step counts
    and learning rate, the schedule's count, the envs and the generator
    equal bit for bit."""
    ma, mb = a.model.state_dict(), b.model.state_dict()
    assert list(ma) == list(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["count"] == ob["count"] and oa["adam"]["param_groups"] == ob["adam"]["param_groups"]
    assert oa["adam"]["state"].keys() == ob["adam"]["state"].keys()
    for i, s in oa["adam"]["state"].items():
        assert s.keys() == ob["adam"]["state"][i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in s.items():
            assert torch.equal(v, ob["adam"]["state"][i][k]), (i, k)
    for f in ("board", "score", "done", "step_count"):
        assert torch.equal(getattr(a.env_state, f), getattr(b.env_state, f)), f
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("anneal_lr, mask_illegal, shuffle_mode",
                         list(itertools.product((False, True), (False, True),
                                                ("global", "sharded"))))
def test_buffered_iterations_equal_eager(anneal_lr, mask_illegal, shuffle_mode):
    """Two whole ``train_iteration``s with the buffered step and with the
    eager one from one seed: each step's metrics and the whole state after
    them equal bit for bit; the holder was built once, warmed up by the
    first two steps and ran the rest."""
    kw = dict(anneal_lr=anneal_lr, mask_illegal=mask_illegal, shuffle_mode=shuffle_mode)
    eager, buffered = trainer(False, **kw), trainer(True, **kw)
    ea, ba = keep_steps(eager), keep_steps(buffered)
    a = iterations(eager, eager.init_state(), 2)
    b = iterations(buffered, buffered.init_state(), 2)
    assert len(ea) == len(ba) == 2 * STEPS
    for k, ((x, _), (y, _)) in enumerate(zip(ea, ba)):
        assert torch.equal(x, y), k
    assert_same_state(a, b)
    assert eager._sgd_graph is None
    holder = buffered._sgd_graph
    # off the card nothing is captured
    assert holder.graphed.warm == graphs.WARMUP and holder.graphed.graph is None
    assert b.optimizer.adam.param_groups[0]["lr"] == buffered.lr_fn(2 * STEPS - 1)


def test_returned_metrics_outlive_later_steps():
    """The first epoch's returned metrics (the benchmark keeps their losses)
    are tensors of their own, unchanged by every later step."""
    tr = trainer(True)
    kept = keep_steps(tr)
    iterations(tr, tr.init_state(), 2)
    first_epoch = kept[:STEPS // 2]
    assert all(torch.equal(aux, snap) for aux, snap in first_epoch)
    ptrs = {aux.data_ptr() for aux, _ in kept}
    assert len(ptrs) == len(kept) and tr._sgd_graph.aux.data_ptr() not in ptrs
    assert not torch.equal(kept[0][1], kept[-1][1])


def test_loading_the_optimizer_rebuilds_the_holder():
    """``Optimizer.load_state_dict`` (new Adam state) makes the next step
    build a new holder, which warms up again; the steps still equal the
    eager learner's doing the same."""
    states = []
    for graph in (False, True):
        tr = trainer(graph)
        state = iterations(tr, tr.init_state(), 1)
        first = tr._sgd_graph
        state.optimizer.load_state_dict(state.optimizer.state_dict())
        kept = keep_steps(tr)
        state = iterations(tr, state, 1)
        if graph:
            assert tr._sgd_graph is not first and tr._sgd_graph.graphed.warm == graphs.WARMUP
            key = ppo._SgdGraph.key_of(tr, state, ppo.UpdateBatch(*first.inputs.tensors()))
            assert key == tr._sgd_graph.key != first.key
        states.append((state, kept))
    (a, ka), (b, kb) = states
    assert all(torch.equal(x, y) for (x, _), (y, _) in zip(ka, kb))
    assert_same_state(a, b)


def test_checkpoints_cross_between_eager_and_buffered(tmp_path):
    """An eager learner's checkpoint resumes on the buffered step, whose
    checkpoint resumes on the eager step: three iterations so, through the
    ``Checkpointer``, equal bit for bit to three eager ones, and each
    checkpoint restores into a fresh state of either path alike."""
    ck = tck.Checkpointer(tmp_path)
    path = trainer(False)
    state = iterations(path, path.init_state(), 1)
    ck.save(1, state)
    for step, graph in ((1, True), (2, False)):
        tr = trainer(graph)
        fresh = tr.init_state(torch.Generator().manual_seed(99))
        state = iterations(tr, ck.restore(step, like=fresh), 1)
        ck.save(step + 1, state)
    eager = trainer(False)
    want = iterations(eager, eager.init_state(), 3)
    assert_same_state(state, want)
    again = trainer(True)
    assert_same_state(ck.restore(3, like=again.init_state(torch.Generator().manual_seed(5))),
                      want)


@pytest.mark.parametrize("graph", [False, True])
def test_spans_and_counters(graph):
    """``ppo.sgd_steps`` counts every SGD step; off the card no step is a
    replay (``ppo.sgd_replays`` absent). The buffered path's steps after
    the warm-ups run in ``ppo.sgd``, the warm-ups and the eager path in
    ``ppo.forward``/``.backward``/``.optimizer``."""
    tr = trainer(graph)
    state = tr.init_state()
    calls = []
    profiler.clear()
    try:
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU]):
                state, _ = tr.train_iteration(state)
            calls.append(profiler.summary())
            profiler.clear()
    finally:
        profiler.clear()
    for k, summary in enumerate(calls):
        assert summary["counters"] == {"ppo.sgd_steps": STEPS}
        spans = {name: s["calls"] for name, s in summary["spans"].items()}
        eager_steps = (graphs.WARMUP if k == 0 else 0) if graph else STEPS
        for name in ("ppo.forward", "ppo.backward", "ppo.optimizer"):
            assert spans.get(name, 0) == eager_steps, (k, name)
        assert spans.get("ppo.sgd", 0) == STEPS - eager_steps, k
        assert spans["ppo.iteration"] == 1


def test_graphed_by_default_on_one_card_only():
    """The buffered step is the default on a CUDA device (one rank), never
    off the card."""
    cfg = ppo.PPOConfig(**TINY)
    assert ppo.PPO(cfg, device="cuda").graph_sgd
    assert not ppo.PPO(cfg, device="cpu").graph_sgd
