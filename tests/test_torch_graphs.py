"""``utils/graphs.py::GraphedStep`` off the card, where it captures nothing:
its warm-ups run the holder's eager function with their arguments and hand
back its result, every later step calls ``run`` with its arguments, and no
replay is counted. The capture and the side stream run only on the card
(``chip_smoke.py`` phases 15g, 19f and 19g)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

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
