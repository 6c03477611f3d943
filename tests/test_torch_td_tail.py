"""The TD step's tail on static buffers (``TDTrainer._scan_steps`` and
``train/td.py::_StepTail``): everything of a step after its greedy search
(``_GreedySearch``), each of which on a CUDA device is one CUDA graph
replay. Off the card a replay is a plain call of the same code on the same
buffers, so these tests hold the buffers' data flow on the CPU: bit for bit
against the JAX step on JAX's draws, and against the step written out on
fresh tensors (``chip_smoke.reference_td_steps``) over whole chunks
(delayed TC and not, the carousel on and off, both nets and the small
net's split lookup), with the returned states untouched by later chunks.
The capture itself runs only on the card (``chip_smoke.py`` phase 15g,
``test_torch_td_greedy.py``'s test marked ``card``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gym2048_tpu.train import td as jtd
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.train import td as ttd
from gym2048_tpu_torch.utils import profiler
from test_torch_td import (BASE, MODES, assert_bits, boards, dead_boards, feed, jax_draws,
                           step_carry)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TAIL_MODES = {**MODES, "carousel_tc_every_2": dict(tc=True, tc_every=2, chunk_steps=2,
                                                   carousel=0.5, carousel_slots=256)}


@pytest.mark.parametrize("mode", list(TAIL_MODES))
def test_replayed_step_matches_jax(mode):
    """``test_torch_td.py::test_chunk_body_step_matches_jax`` through the
    static tail: one step (with ``tc_every``, a window of two) from one
    carry on JAX's draws, every leaf and stat equal bit for bit."""
    kw = {**BASE, **TAIL_MODES[mode]}
    n = 24
    jtr = jtd.TDTrainer(jtd.TDConfig(n_envs=n, **kw))
    ttr = ttd.TDTrainer(ttd.TDConfig(n_envs=n, **kw), device="cpu")
    carry = step_carry(11, n, kw, jtr._net)
    alpha = 0.5
    key = jnp.asarray(carry["key"])
    steps = kw.get("chunk_steps", 1)
    draws = []
    for _ in range(steps):
        key, d = jax_draws(key, n, bool(kw.get("carousel")))
        draws.append(d)
    with jax.disable_jit():
        jcarry = {k: jnp.asarray(v) for k, v in carry.items()}
        if steps > 1:
            want, wstats = jtr._scan_steps(jcarry, jnp.float32(alpha), steps)
        else:
            want, wstats = jtr._chunk_body(jnp.float32(alpha))(jcarry, None)
            wstats = tuple(np.asarray(w)[None] for w in wstats)
    tcarry = interop.train_state_from_numpy(carry, "cpu")
    tcarry["generator"] = torch.Generator()
    feed(ttr, draws)
    got, gstats = ttr._scan_steps(tcarry, torch.tensor(alpha, dtype=torch.float32), steps)
    del got["generator"]
    assert set(got) == set(want) - {"key"}
    for k in got:
        if k == "car_boards":  # row 0 takes the non-crossing envs' writes
            assert_bits(got[k][1:], np.asarray(want[k])[1:], k)
        else:
            assert_bits(got[k], want[k], k)
    for g, w in zip(gstats, wstats):
        assert_bits(g, w)
    assert ttr._tail.graphed.graph is None  # off the card nothing is captured


# delayed TC with and without the carousel, TC and plain TD on every step,
# and the small net (TC and not)
CHUNK_CASES = {
    "deferred_carousel": dict(BASE, tc=True, tc_every=2, carousel=0.5, carousel_slots=8),
    "deferred": dict(BASE, thresholds=(), tc=True, tc_every=4),
    "tc_carousel": dict(BASE, tc=True, carousel=0.5, carousel_slots=8),
    "td": dict(BASE, tc=False),
    "small_tc": dict(tc=True, alpha=1.0, alpha_final=1.0, init_value=0.0),
    "small_td": dict(alpha=0.1, alpha_final=0.1, init_value=1000.0),
    "small_td_split": dict(alpha=0.1, alpha_final=0.1, init_value=1000.0,
                           update_impl="mxu", value_impl="mxu"),
}


def crowded_state(trainer, seed: int) -> dict:
    """A fresh state whose boards are crowded, three of them dead, so games
    end and restart within a chunk."""
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    n = state["boards"].shape[0]
    state["boards"] = torch.from_numpy(np.concatenate(
        [boards(n - 3, seed, max_exp=5, p_zero=0.15), dead_boards(3)]))
    return state


def chunks(trainer, state: dict, scan, count: int) -> list[tuple[dict, tuple, dict]]:
    """``count`` chunks of ``scan`` from ``state`` (its generator copied):
    each chunk's returned state, its stats, and a snapshot of that state's
    tensors taken when it was returned (the generator is carried on, as
    ``train_chunk`` documents)."""
    gen = torch.Generator().manual_seed(0)
    gen.set_state(state["generator"].get_state())
    state = dict(state, generator=gen)
    out = []
    for _ in range(count):
        state, stats = scan(state, torch.tensor(trainer.cfg.alpha), trainer.cfg.chunk_steps)
        snap = {k: v.clone() for k, v in state.items() if k != "generator"}
        out.append((state, stats, snap))
    return out


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_replayed_chunks_equal_eager_chunks(case):
    """Three chunks through the static tail and through the reference step
    on fresh tensors: every leaf, the generator and every stat equal bit
    for bit; a returned state is not changed by the chunks after it."""
    tr = ttd.TDTrainer(ttd.TDConfig(n_envs=16, chunk_steps=8, **CHUNK_CASES[case]), "cpu")
    state = crowded_state(tr, 5)
    eager = chunks(tr, state, functools.partial(chip_smoke.reference_td_steps, tr), 3)
    replayed = chunks(tr, state, tr._scan_steps, 3)
    for (a, sa, _), (b, sb, snap) in zip(eager, replayed):
        assert set(a) == set(b) == set(state)
        for k in a:
            if k == "generator":
                assert torch.equal(a[k].get_state(), b[k].get_state())
            else:
                assert_bits(b[k], a[k].numpy(), k)
        for x, y in zip(sa, sb):
            assert_bits(y, x.numpy())
    for b, sb, snap in replayed:  # later chunks left the returned states alone
        for k, v in snap.items():
            assert torch.equal(b[k], v), k
        assert all(s.shape == (tr.cfg.chunk_steps,) for s in sb)
    assert sum(float(s[0].sum()) for _, s, _ in replayed) >= 3  # games ended and restarted


def test_train_chunk_and_learn_through_the_tail(monkeypatch):
    """``train_chunk`` (and so ``learn`` and the one-rank sharded chunk)
    through the static tail, against ``learn`` with the reference step in
    place of ``_scan_steps``: the same states and metrics."""
    cfg = ttd.TDConfig(n_envs=16, chunk_steps=4, total_steps=16 * 4 * 3,
                       **CHUNK_CASES["deferred_carousel"])
    want_tr, got_tr = ttd.TDTrainer(cfg, "cpu"), ttd.TDTrainer(cfg, "cpu")
    monkeypatch.setattr(want_tr, "_scan_steps",
                        functools.partial(chip_smoke.reference_td_steps, want_tr))
    want, wh = want_tr.learn(log_fn=None, log_every=1)
    got, gh = got_tr.learn(log_fn=None, log_every=1)
    assert got_tr._tail is not None and want_tr._tail is None
    for k in want:
        if k == "generator":
            assert torch.equal(want[k].get_state(), got[k].get_state())
        else:
            assert_bits(got[k], want[k].numpy(), k)
    strip = lambda h: [dataclasses.replace(e, wall=0.0) for e in h]  # noqa: E731
    assert strip(gh) == strip(wh)


def test_tail_replays_read_zero_off_the_card():
    """Off the card the tail makes plain calls: ``train_chunk``'s spans
    are the step's own (``td.update`` and ``td.restart`` inside the tail's
    calls, no ``td.tail``, which opens only around a graph's replay), and
    the replay counter never counts, in ``train_chunk`` or in a bare
    ``_scan_steps``; the combine counts each of its two windows."""
    tr = ttd.TDTrainer(ttd.TDConfig(n_envs=16, chunk_steps=4,
                                    **CHUNK_CASES["deferred_carousel"]), "cpu")
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            state, _ = tr.train_chunk(tr.init_state(), 1.0)
        s = profiler.summary()
        assert s["counters"] == {"td.steps": 4, "td.sparse_combines": 2}
        assert "td.tail" not in s["spans"]
        assert s["spans"]["td.update"]["calls"] == s["spans"]["td.restart"]["calls"] == 4
        profiler.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            tr._scan_steps(state, torch.tensor(1.0), 4)
        s = profiler.summary()
    finally:
        profiler.clear()
    assert not tr._tail.graphed.captures
    assert s["counters"].get("td.tail_replays", 0) == 0 and "td.tail" not in s["spans"]
    assert s["spans"]["td.update"]["calls"] == s["spans"]["td.restart"]["calls"] == 4


def test_the_tail_is_built_again_for_new_shapes_steps_or_mode():
    tr = ttd.TDTrainer(ttd.TDConfig(n_envs=16, chunk_steps=4,
                                    **CHUNK_CASES["deferred_carousel"]), "cpu")
    state = tr.init_state()
    alpha = torch.tensor(1.0)
    state, _ = tr._scan_steps(state, alpha, 4)
    first = tr._tail
    state, _ = tr._scan_steps(state, alpha, 4)
    assert tr._tail is first
    state, stats = tr._scan_steps(state, alpha, 2)
    assert tr._tail is not first and stats[0].shape == (2,)
    second = tr._tail
    torch.use_deterministic_algorithms(True)
    try:
        tr._scan_steps(state, alpha, 2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert tr._tail is not second
    third = tr._tail
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not tf32
    try:
        tr._scan_steps(state, alpha, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert tr._tail is not third
    half = {k: (v[:8] if k in ttd._BATCH_KEYS else v) for k, v in state.items()}
    tr._scan_steps(half, alpha, 2)
    assert tr._tail.inputs[1].shape == (8,)


def test_a_scan_cut_short_leaves_no_pending_sums(monkeypatch):
    """A scan that raises between combines leaves sums in the tail's
    pending buffers; the next scan starts from zero sums all the same, as a
    fresh trainer's scan does."""
    cfg = ttd.TDConfig(n_envs=16, chunk_steps=4, **CHUNK_CASES["deferred_carousel"])
    tr, clean = ttd.TDTrainer(cfg, "cpu"), ttd.TDTrainer(cfg, "cpu")
    alpha = torch.tensor(1.0)
    state, _ = tr._scan_steps(crowded_state(tr, 9), alpha, 4)  # prev_valid set
    calls = []
    real = ttd._greedy_batch

    def cut(*args):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*args)

    monkeypatch.setattr(ttd, "_greedy_batch", cut)
    with pytest.raises(KeyboardInterrupt):
        tr._scan_steps(dict(state, generator=torch.Generator().manual_seed(2)), alpha, 4)
    assert any(bool(tr._tail.carry[p].any()) for p in ttd._PENDING)
    monkeypatch.setattr(ttd, "_greedy_batch", real)
    got, gs = tr._scan_steps(dict(state, generator=torch.Generator().manual_seed(3)),
                                alpha, 4)
    want, ws = clean._scan_steps(dict(state, generator=torch.Generator().manual_seed(3)),
                                 alpha, 4)
    for k in want:
        if k != "generator":
            assert_bits(got[k], want[k].numpy(), k)
    for g, w in zip(gs, ws):
        assert_bits(g, w.numpy())
