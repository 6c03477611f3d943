"""The port's profiling and tracing (gym2048_tpu_torch.utils.profiler) on the
CPU: ``trace`` writes a Chrome trace file that names the program's spans and
the work inside them; ``span`` and ``count`` record nothing unless a
profiler records, and while one does they record each span's name, parent,
unit id and interval on the profiler's clock; the TD chunk and the PPO
iteration record their phases and train to the same state either way."""

import contextlib
import dataclasses
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gym2048_tpu_torch.train import ppo, td
from gym2048_tpu_torch.utils import profiler

TD_CFG = td.TDConfig(arch="4x6", n_vals=4, thresholds=(2, 3), tc=True, tc_every=2,
                     carousel=0.5, carousel_slots=8, n_envs=16, chunk_steps=4, alpha=1.0,
                     alpha_final=1.0, init_value=0.0)
PPO_CFG = ppo.PPOConfig(n_envs=8, n_steps=8, batch_size=16, n_epochs=2, filters=8,
                        residual_blocks=1, shuffle_mode="sharded")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_recorder():
    profiler.clear()
    yield
    profiler.clear()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=2, init_value=100.0), "cpu")
    state = tr.init_state()
    with profiler.trace(tmp_path / "traces") as prof:
        with profiler.span("outer"):
            state, _ = tr.train_chunk(state, 0.1)
    assert prof.trace_path is not None and prof.trace_path.parent == tmp_path / "traces"
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"outer", "td.chunk", "td.greedy", "td.lookup"} <= names
    assert any(n and n.startswith("aten::") for n in names)
    assert {"outer", "td.chunk"} <= {e.key for e in prof.key_averages()}
    assert profiler.RECORDER.records[1][:3] == ["td.chunk", 0, 1]


def test_trace_default_directory_is_under_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiler.trace() as prof:
        torch.ones(4).sum()
    assert prof.trace_path.parent == tmp_path / "torch-trace"


def test_span_off_checks_the_flag_and_does_nothing_else(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("called with no profiler recording")

    assert not profiler.profiler_enabled()
    with monkeypatch.context() as m:
        m.setattr(profiler, "_range", forbidden)
        m.setattr(torch.profiler, "record_function", forbidden)
        m.setattr(time, "time_ns", forbidden)
        first, second = profiler.span("a"), profiler.span("b", unit=3)
        assert first is second  # the one shared no-op context
        with first:
            with second:
                profiler.count("n", 5)
    assert profiler.RECORDER.records == [] and profiler.summary() == {"spans": {},
                                                                      "counters": {}}


def test_span_on_records_name_parent_unit_and_self_time():
    with recording():
        with profiler.span("root", unit=7):
            profiler.count("n", 2)
            with profiler.span("child"):
                time.sleep(0.002)
                with profiler.span("leaf"):
                    time.sleep(0.002)
            with profiler.span("child"):
                time.sleep(0.002)
            profiler.count("n", 3)
        with profiler.span("other", unit=8):
            pass
    recs = profiler.RECORDER.records
    assert [r[:3] for r in recs] == [["root", -1, 7], ["child", 0, 7], ["leaf", 1, 7],
                                     ["child", 0, 7], ["other", -1, 8]]
    assert all(r[3] <= r[4] for r in recs)
    assert recs[0][3] <= recs[1][3] and recs[3][4] <= recs[0][4]
    s = profiler.summary()
    assert s["counters"] == {"n": 5}
    spans = s["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {"root": 1, "child": 2, "leaf": 1,
                                                         "other": 1}
    ns = lambda r: (r[4] - r[3]) / 1e9  # noqa: E731
    assert spans["child"]["total_s"] == pytest.approx(ns(recs[1]) + ns(recs[3]))
    assert spans["root"]["self_s"] == pytest.approx(
        spans["root"]["total_s"] - spans["child"]["total_s"])
    assert spans["child"]["self_s"] == pytest.approx(
        spans["child"]["total_s"] - spans["leaf"]["total_s"])
    assert spans["leaf"]["self_s"] == spans["leaf"]["total_s"] >= 0.002
    assert sum(v["self_s"] for k, v in spans.items() if k != "other") == pytest.approx(
        spans["root"]["total_s"])
    profiler.clear()
    assert profiler.summary() == {"spans": {}, "counters": {}}


def test_span_clock_matches_the_profiler_events():
    with recording() as prof:
        for k in range(5):
            with profiler.span(f"clock.{k}"):
                torch.ones(64).cumsum(0)
                time.sleep(0.001)
    kineto = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    recs = profiler.RECORDER.records
    assert len(recs) == len(kineto) == 5
    for name, _, _, start, end in recs:
        k_start, k_end = kineto[name]
        assert abs(start - k_start) < 1_000_000 and abs(end - k_end) < 1_000_000


def test_td_chunk_records_its_phases():
    tr = td.TDTrainer(TD_CFG, "cpu")
    state = tr.init_state()
    with recording():
        tr.train_chunk(state, 1.0)
    s = profiler.summary()
    calls = {k: v["calls"] for k, v in s["spans"].items()}
    steps = TD_CFG.chunk_steps
    assert calls == {"td.chunk": 1, "td.greedy": steps, "td.lookup": steps, "td.update": steps,
                     "td.restart": steps, "td.combine": steps // TD_CFG.tc_every}
    assert s["counters"] == {"td.steps": steps, "td.sparse_combines": steps // TD_CFG.tc_every}
    parents = {r[0]: profiler.RECORDER.records[r[1]][0] for r in profiler.RECORDER.records
               if r[1] >= 0}
    assert parents == {"td.greedy": "td.chunk", "td.lookup": "td.greedy",
                       "td.update": "td.chunk", "td.restart": "td.chunk",
                       "td.combine": "td.chunk"}
    assert {r[2] for r in profiler.RECORDER.records} == {1}
    assert sum(v["self_s"] for v in s["spans"].values()) == pytest.approx(
        s["spans"]["td.chunk"]["total_s"])


def test_ppo_iteration_records_its_phases():
    trainer = ppo.PPO(PPO_CFG, "cpu")
    state = trainer.init_state()
    with recording():
        trainer.train_iteration(state)
    s = profiler.summary()
    calls = {k: v["calls"] for k, v in s["spans"].items()}
    sgd = PPO_CFG.n_epochs * PPO_CFG.n_minibatches
    assert calls == {"ppo.iteration": 1, "ppo.policy": PPO_CFG.n_steps + 1,
                     "ppo.env": PPO_CFG.n_steps, "ppo.gae": 1, "ppo.forward": sgd,
                     "ppo.backward": sgd, "ppo.optimizer": sgd}
    assert {r[2] for r in profiler.RECORDER.records} == {0}
    assert sum(v["self_s"] for v in s["spans"].values()) == pytest.approx(
        s["spans"]["ppo.iteration"]["total_s"])


def _td_run(traced: bool):
    tr = td.TDTrainer(TD_CFG, "cpu")
    state = tr.init_state()
    with recording() if traced else contextlib.nullcontext():
        for _ in range(2):
            state, metrics = tr.train_chunk(state, 1.0)
    return {**state, "generator": state["generator"].get_state()}, metrics


def _ppo_run(traced: bool):
    trainer = ppo.PPO(PPO_CFG, "cpu")
    state = trainer.init_state()
    with recording() if traced else contextlib.nullcontext():
        state, metrics = trainer.train_iteration(state)
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update((f"env.{f.name}", getattr(state.env_state, f.name))
               for f in dataclasses.fields(state.env_state))
    for i, st in state.optimizer.adam.state.items():
        out.update((f"adam.{i}.{k}", v) for k, v in st.items())
    out["generator"] = state.generator.get_state()
    return out, metrics


@pytest.mark.parametrize("run", [_td_run, _ppo_run], ids=["td", "ppo"])
def test_spans_leave_training_bit_identical(run):
    plain_state, plain_metrics = run(False)
    assert profiler.RECORDER.records == []
    traced_state, traced_metrics = run(True)
    assert profiler.RECORDER.records
    for got, want in ((traced_state, plain_state), (traced_metrics, plain_metrics)):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
