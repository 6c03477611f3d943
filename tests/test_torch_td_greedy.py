"""The TD step's greedy search as a step holder (``train/td.py::_GreedySearch``):
on a CUDA device one graph replay a step ahead of the tail's, reading the
table at one address, which the delayed-TC combine and the update without
delayed TC write in place. Off the card every replay is a plain call of the
same code, so the CPU tests here hold the data flow: whole chunks bit for
bit against the step written out on fresh tensors
(``chip_smoke.reference_td_steps``, the parent's order of the search, the
update, the tail and the combine), the given state untouched, the holder
rebuilt when it must be, and the counters and spans (whole chunks of every
mode are held to the written-out step in ``test_torch_td_tail.py``). The
test marked
``card`` runs the graphs themselves and skips elsewhere; on the card:
``python -m pytest --noconftest -m card tests/test_torch_td_greedy.py``.

The file imports no JAX (the card's machine has none)."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gym2048_tpu_torch.models import ntuple_big
from gym2048_tpu_torch.train import td
from gym2048_tpu_torch.utils import graphs, profiler


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STAGED = dict(arch="4x6", n_vals=4, thresholds=(2, 3), alpha=0.5, alpha_final=0.5,
              init_value=0.0)
CASES = {
    # delayed TC on a staged big-net layout, the carousel off and on
    "staged_delayed_tc": dict(STAGED, tc=True, tc_every=4),
    "staged_delayed_tc_carousel": dict(STAGED, tc=True, tc_every=2, carousel=0.5,
                                       carousel_slots=8),
    # tc_every == 1 on the small net: the eager update writes the table
    "small_tc": dict(tc=True, alpha=1.0, alpha_final=1.0, init_value=0.0),
    "small_td_split": dict(alpha=0.1, alpha_final=0.1, init_value=1000.0,
                           update_impl="mxu", value_impl="mxu"),
    "staged_td": dict(STAGED, tc=False),
}


def crowded_state(trainer, seed: int) -> dict:
    """A fresh state whose boards are crowded, three of them dead, so games
    end and restart within a chunk."""
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    n = state["boards"].shape[0]
    rng = np.random.default_rng(seed)
    b = np.where(rng.random((n, 4, 4)) < 0.15, 0, rng.integers(1, 6, (n, 4, 4)))
    b[-3:] = np.indices((4, 4)).sum(0) % 2 + 1  # no legal move
    state["boards"] = torch.from_numpy(b.astype(np.int8))
    return state


def run_chunks(trainer, state: dict, scan, count: int) -> list[tuple[dict, tuple]]:
    """``count`` chunks of ``scan`` from ``state`` (its generator copied),
    each chunk's returned state and stats."""
    gen = torch.Generator(device=state["generator"].device)
    gen.set_state(state["generator"].get_state())
    state = dict(state, generator=gen)
    alpha = torch.tensor(trainer.cfg.alpha)
    out = []
    for _ in range(count):
        state, stats = scan(state, alpha, trainer.cfg.chunk_steps)
        out.append((state, stats))
    return out


def snapshot(state: dict) -> dict:
    return {k: v.clone() for k, v in state.items() if torch.is_tensor(v)}


def assert_states_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if k == "generator":
            assert torch.equal(got[k].get_state(), want[k].get_state())
        else:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_each_step_calls_the_search_and_the_lookup_through_their_modules(case, monkeypatch):
    """Off the card each step of a chunk calls ``td._greedy_batch`` once
    and (but for the small net's split lookup) ``ntuple_big.gather_values``
    once, looked up in their modules at the call (so a wrapper put there
    counts every step), and the chunk equals the step written out on fresh
    tensors.
    (``test_torch_td_tail.py::test_replayed_chunks_equal_eager_chunks``
    holds three chunks of every mode to it, stats included.)"""
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=8, **CASES[case]), "cpu")
    state = crowded_state(tr, 5)
    (want, _), = run_chunks(tr, state, functools.partial(chip_smoke.reference_td_steps, tr), 1)
    calls = {"search": 0, "lookup": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(td, "_greedy_batch", counted(td._greedy_batch, "search"))
    monkeypatch.setattr(ntuple_big, "gather_values", counted(ntuple_big.gather_values, "lookup"))
    (got, _), = run_chunks(tr, state, tr._scan_steps, 1)
    assert_states_equal(got, want)
    assert calls["search"] == tr.cfg.chunk_steps
    split = tr._small is not None and tr._small.value_impl != "gather"  # ntuple's lookups
    assert calls["lookup"] == (0 if split else tr.cfg.chunk_steps)
    assert tr._greedy.graphed.graph is None and not tr._greedy.graphed.captures


@pytest.mark.parametrize("case", ["staged_delayed_tc_carousel", "small_tc", "staged_td"])
def test_train_chunk_leaves_the_given_state(case):
    """The combine and the update write the scan's table in place, yet
    ``train_chunk`` leaves the state it is given as it was (``table``,
    ``tc_e``, ``tc_a`` and every other leaf), and a later chunk leaves the
    state that an earlier one returned."""
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=4, **CASES[case]), "cpu")
    given = crowded_state(tr, 7)
    before = snapshot(given)
    first, _ = tr.train_chunk(given, tr.cfg.alpha)
    after_first = snapshot(first)
    second, _ = tr.train_chunk(first, tr.cfg.alpha)
    for k, v in before.items():
        assert torch.equal(given[k], v), k
    for k, v in after_first.items():
        assert torch.equal(first[k], v), k
    assert not torch.equal(first["table"], before["table"])  # the chunk learnt
    assert not torch.equal(second["table"], after_first["table"])
    assert first["table"] is not tr._tail.carry["table"]
    assert second["table"] is not tr._tail.carry["table"]


def test_the_search_is_built_again_for_new_shapes_steps_flags_or_table():
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=4, **CASES["small_tc"]), "cpu")
    state = tr.init_state()
    alpha = torch.tensor(1.0)
    state, _ = tr._scan_steps(state, alpha, 4)
    first = tr._greedy
    assert first.table is tr._tail.carry["table"] and first.boards is tr._tail.carry["boards"]
    state, _ = tr._scan_steps(state, alpha, 4)
    assert tr._greedy is first  # the same holder, chunk after chunk
    state, _ = tr._scan_steps(state, alpha, 2)  # a new step count
    assert tr._greedy is not first
    second = tr._greedy
    torch.use_deterministic_algorithms(True)  # new kernel flags
    try:
        tr._scan_steps(state, alpha, 2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert tr._greedy is not second
    third = tr._greedy
    half = {k: (v[:8] if k in td._BATCH_KEYS else v) for k, v in state.items()}
    tr._scan_steps(half, alpha, 2)  # new shapes
    assert tr._greedy is not third and tr._greedy.out[0].shape == (8, 4, 4)
    fourth = tr._greedy
    from gym2048_tpu_torch.models import ntuple

    staged = dict(half, table=ntuple.promote_table(half["table"], 2),
                  tc_e=ntuple.promote_table(half["tc_e"], 2),
                  tc_a=ntuple.promote_table(half["tc_a"], 2))
    tr._scan_steps(staged, alpha, 2)  # a new table
    assert tr._greedy is not fourth and tr._greedy.table.numel() == staged["table"].numel()
    # the identity of the table buffer keys the search
    fifth = tr._greedy
    assert fifth.fits(tr._tail)
    tr._tail.carry["table"] = tr._tail.carry["table"].clone()
    assert not fifth.fits(tr._tail)
    tr._scan_steps(staged, alpha, 2)
    assert tr._greedy is not fifth and tr._greedy.table is tr._tail.carry["table"]


def test_greedy_replays_read_zero_off_the_card():
    """Off the card the search makes plain calls: the replay counter never
    counts (the combine counts each of its four windows), and each step
    opens ``td.greedy`` (with its ``td.lookup``) once, inside
    ``_greedy_batch``, never one inside another."""
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=4,
                                  **CASES["staged_delayed_tc_carousel"]), "cpu")
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            state, _ = tr.train_chunk(tr.init_state(), 1.0)
            tr.train_chunk(state, 1.0)
        s = profiler.summary()
        records = list(profiler.RECORDER.records)
    finally:
        profiler.clear()
    assert not tr._greedy.graphed.captures
    assert s["counters"] == {"td.steps": 8, "td.sparse_combines": 4}
    assert s["spans"]["td.greedy"]["calls"] == s["spans"]["td.lookup"]["calls"] == 8
    for name, parent, *_ in records:
        while name == "td.greedy" and parent >= 0:
            assert records[parent][0] != "td.greedy"
            parent = records[parent][1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the lookup kernel)")
    return torch.device("cuda")


CARD_CASES = {
    "staged_delayed_tc_carousel": dict(arch="4x6", n_vals=8, thresholds=(5, 7), tc=True,
                                       tc_every=4, carousel=0.5, carousel_slots=16,
                                       alpha=1.0, alpha_final=1.0, init_value=0.0),
    "small_tc": CASES["small_tc"],
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_graphed_chunks_equal_eager_chunks_on_the_card(card, case):
    """On the card, in deterministic mode (which fixes ``index_add_``'s
    order): two chunks whose searches and tails are graph replays equal the
    step written out eagerly, every leaf, the generator and every stat;
    every step after a holder's warm-ups is a replay, each in one
    ``td.greedy`` span that holds no other."""
    tr = td.TDTrainer(td.TDConfig(n_envs=1024, chunk_steps=8, **CARD_CASES[case]), card)
    state, _ = tr.train_chunk(tr.init_state(), tr.cfg.alpha)
    steps = tr.cfg.chunk_steps
    torch.use_deterministic_algorithms(True)
    profiler.clear()
    try:
        want = run_chunks(tr, state, functools.partial(chip_smoke.reference_td_steps, tr), 2)
        with profile(activities=[ProfilerActivity.CPU]):
            got = run_chunks(tr, state, tr._scan_steps, 2)
            torch.cuda.synchronize()
        s = profiler.summary()
        records = list(profiler.RECORDER.records)
    finally:
        torch.use_deterministic_algorithms(False)
        profiler.clear()
    for (a, sa), (b, sb) in zip(want, got):
        assert_states_equal(b, a)
        for x, y in zip(sa, sb):
            assert torch.equal(x, y)
    replays = 2 * steps - graphs.WARMUP
    assert s["counters"]["td.greedy_replays"] == s["counters"]["td.tail_replays"] == replays
    assert tr._greedy.graphed.graph is not None and tr._tail.graphed.graph is not None
    # the warm-ups' and the capture's spans inside _greedy_batch, one a replay
    assert s["spans"]["td.greedy"]["calls"] == graphs.WARMUP + 1 + replays
    for name, parent, *_ in records:
        while name == "td.greedy" and parent >= 0:
            assert records[parent][0] != "td.greedy"
            parent = records[parent][1]
