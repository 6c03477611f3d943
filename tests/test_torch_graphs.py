"""``utils/graphs.py::GraphedStep`` off the card, where it captures nothing:
its warm-ups run the holder's eager function with their arguments and hand
back its result, every later step calls ``run`` with its arguments, and no
replay is counted. The capture and the side stream run only on the card
(``chip_smoke.py`` phases 15g, 19f and 19g); with the graph faked, a holder
that captures opens its span around each replay and chip_smoke counts a
replay's kernels (``count_replayed_launches``)."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gym2048_tpu_torch.models import table_gather
from gym2048_tpu_torch.utils import graphs, profiler


def test_warm_ups_then_plain_calls_off_the_card():
    calls = []
    step = graphs.GraphedStep(lambda *a: calls.append(("run", a)), "test.replays",
                              torch.device("cpu"))
    assert not step.captures
    got = []
    for k in range(graphs.WARMUP + 3):
        if step.warming:
            got.append(step.eager(lambda *a: calls.append(("eager", a)) or k, k, "x"))
        else:
            step.replay(k)
    assert got == list(range(graphs.WARMUP))
    assert calls == ([("eager", (k, "x")) for k in range(graphs.WARMUP)]
                     + [("run", (k,)) for k in range(graphs.WARMUP, graphs.WARMUP + 3)])
    assert step.warm == graphs.WARMUP and not step.warming and step.graph is None


@pytest.mark.parametrize("device", [None, torch.device("cpu")])
def test_no_replay_is_counted_off_the_card(device):
    buf = torch.zeros(3)
    step = graphs.GraphedStep(lambda: buf.add_(1), "test.replays", device)
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(graphs.WARMUP):
                step.eager(step.run)
            for _ in range(4):
                step.replay()
        assert profiler.summary()["counters"] == {}
    finally:
        profiler.clear()
    assert torch.equal(buf, torch.full((3,), float(graphs.WARMUP + 4)))


class _FakeGraph:
    """A captured graph off the card: the capture runs the step once, a
    replay runs nothing."""

    def replay(self):
        pass


def test_a_replay_counts_its_captured_launches_once_and_opens_its_span(monkeypatch):
    """``chip_smoke.count_replayed_launches`` on a step holder that captures
    (the CUDA graph faked): the capture counts the step's launches once,
    each later replay adds them again; the holder's span encloses each
    replay and not the capture, whose own spans stand beside it."""
    monkeypatch.setattr(graphs.GraphedStep, "replay", graphs.GraphedStep.replay)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    chip_smoke.count_replayed_launches()
    chip_smoke.count_replayed_launches()  # once a process: a second call adds nothing

    def run():
        with profiler.span("test.inner"):
            table_gather.LAUNCHES["gather_values"] += 2

    step = graphs.GraphedStep(run, "test.replays", None, span="test.replay")
    step.side = object()  # as on the card: the steps after the warm-ups replay
    step.warm = graphs.WARMUP
    assert step.captures and not step.warming
    launched = table_gather.LAUNCHES["gather_values"]
    profiler.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(5):
                step.replay()
        s = profiler.summary()
        records = list(profiler.RECORDER.records)
    finally:
        profiler.clear()
    assert table_gather.LAUNCHES["gather_values"] - launched == 2 * 5
    assert isinstance(step.graph, _FakeGraph)
    assert s["counters"] == {"test.replays": 5}
    assert s["spans"]["test.replay"]["calls"] == 5 and s["spans"]["test.inner"]["calls"] == 1
    assert all(parent < 0 for _, parent, *_ in records)  # none inside another
