"""Device time by program span and the TD entry's sampled work.

The trace's reduction (``tracing.py``) counts a device operation for every
span whose host range encloses, on the same thread, the runtime call that
launched it: on synthetic raw Kineto events, a kernel of a CUDA graph
replay launched inside ``ppo.sgd`` counts for ``ppo.sgd`` and
``ppo.iteration``, one launched outside counts for neither. The four
metrics of device time by span read nothing on the CPU. The TD entry's
sample (``entries/td_chunk.py::sample_steps``) counts, at a tiny size, the
bytes that wrappers around the program's greedy search and lookup counted
on the same boards up to the learner's first TC combine, and calls neither
of those functions."""

from __future__ import annotations

import json
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import counts, harness, layer_metrics, tracing
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
DEVICE_METRICS = ("greedy_device_us.td", "tail_device_us.td", "rollout_device_ms.ppo",
                  "sgd_device_ms.ppo")


class Event:
    """A raw Kineto event with the methods the reduction reads."""

    def __init__(self, name, start, dur, device=False, corr=0, linked=0, thread=1):
        self._v = (name, start, dur, DeviceType.CUDA if device else DeviceType.CPU, corr,
                   linked, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return False


def runtime(name, start, corr, linked):
    """A runtime call: CUPTI's own thread id and correlation id."""
    return Event(name, start, 5, corr=corr, linked=linked, thread=987654)


# one PPO iteration's host timeline (ns) on thread 1; the runtime call of the
# graph launch has the correlation id 3 in CUPTI's numbering, which is also
# the id of an unrelated host operation in the profiler's
EVENTS = [
    Event("ppo.iteration", 0, 1000, corr=1),
    Event("ppo.sgd", 100, 300, corr=2),
    Event("aten::copy_", 110, 20, corr=3),
    runtime("cudaMemcpyAsync", 115, corr=50, linked=3),
    Event("Memcpy DtoD (Device -> Device)", 500, 20, device=True, corr=50, linked=3),
    runtime("cudaGraphLaunch", 200, corr=3, linked=2),
    Event("sm90_xmma_fprop_implicit_gemm", 600, 100, device=True, corr=3, linked=2),
    Event("gym_bn_apply_kernel", 700, 50, device=True, corr=3, linked=2),
    Event("aten::mul", 500, 20, corr=5),
    runtime("cudaLaunchKernel", 505, corr=52, linked=5),
    Event("vectorized_elementwise_kernel", 800, 50, device=True, corr=52, linked=5),
    # on another thread, inside the spans' time but not their thread
    Event("aten::neg", 150, 10, corr=6, thread=2),
    runtime("cudaLaunchKernel", 152, corr=53, linked=6),
    Event("neg_kernel", 900, 10, device=True, corr=53, linked=6),
    # after the iteration
    Event("aten::add", 1100, 20, corr=4),
    runtime("cudaGraphLaunch", 1105, corr=51, linked=4),
    Event("add_kernel", 1200, 100, device=True, corr=51, linked=4),
    # a call outside every profiled operation, whose id is also aten::mul's
    runtime("cudaStreamSynchronize", 1400, corr=5, linked=0),
]


def profile_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))


def test_a_graph_replay_counts_for_the_spans_around_its_launch():
    names = {"ppo.iteration", "ppo.sgd", "ppo.env"}
    red = tracing.reduce_profile(profile_of(EVENTS), names)
    ctx = tracing.Context(entry=None, units=1, steps=1, window_s=1.0, busy_s=red["busy_s"],
                          ops=red["ops"], op_s=red["op_s"], op_n=red["op_n"],
                          by_spans=red["by_spans"])
    assert red["by_spans"] == {("ppo.iteration", "ppo.sgd"): pytest.approx(170e-9),
                               ("ppo.iteration",): pytest.approx(50e-9),
                               (): pytest.approx(110e-9)}
    assert ctx.span_device_s("ppo.sgd") == pytest.approx(170e-9)
    assert ctx.span_device_s("ppo.iteration") == pytest.approx(220e-9)
    assert ctx.span_device_s("ppo.sgd", "ppo.iteration") == pytest.approx(220e-9)
    assert ctx.span_device_s("ppo.env") == 0.0
    assert ctx.ops == 6 and sum(ctx.op_s.values()) == pytest.approx(330e-9)
    assert ctx.op_launches("kernel") == 4


@pytest.mark.parametrize("spans, scale, per_unit", [
    (("ppo.sgd",), 1e3, 170e-6 / 2),
    (("ppo.env", "ppo.sgd"), 1e3, 170e-6 / 2),
    (("ppo.sgd", "ppo.iteration"), 1e3, 220e-6 / 2),
    (("ppo.env",), 1e3, None),
])
def test_span_device_per_iteration(spans, scale, per_unit, monkeypatch):
    from gym2048_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "summary", lambda: {
        "spans": {"ppo.iteration": {"calls": 2, "total_s": 1.0, "self_s": 0.1}},
        "counters": {}})
    red = tracing.reduce_profile(profile_of(EVENTS), {"ppo.iteration", "ppo.sgd", "ppo.env"})
    ctx = tracing.Context(entry=None, units=2, steps=2, window_s=1.0, busy_s=red["busy_s"],
                          ops=red["ops"], op_s=red["op_s"], by_spans=red["by_spans"])
    got = layer_metrics.span_device(ctx, spans, scale)
    assert got == (pytest.approx(per_unit) if per_unit is not None else None)


def test_the_device_metrics_are_listed_and_read_nothing_on_the_cpu(tiny):
    root, _ = tiny
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for name in DEVICE_METRICS:
        m = by_name[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert m["workloads"] == (["td-4x6-tc"] if name.endswith(".td") else ["ppo-prod-bf16"])
    for cell in ("td-4x6-tc", "ppo-prod-bf16"):
        c = harness.load_cell(f"{cell}-tiny", root)
        entry = harness.load_entry(c, root)(c, 2 ** 31 + 21, torch.device("cpu"))
        entry.setup()
        assert entry.spans() == []
        ctx = tracing.traced_window(entry)
        assert ctx.ops == 0 and ctx.by_spans == {}
        for name in DEVICE_METRICS:
            assert harness.load_metric(name, root)(ctx) is None


def td_entry(tiny, seed):
    """The tiny TD cell without the carousel (whose restarts the sample
    leaves out), set up."""
    root, _ = tiny
    c = harness.load_cell("td-4x6-tc-tiny", root)
    c["traffic"]["carousel"] = 0.0
    entry = harness.load_entry(c, root)(c, seed, torch.device("cpu"))
    entry.setup()
    return entry


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_the_sample_counts_what_wrappers_counted_on_the_same_boards(tiny, seed):
    from gym2048_tpu_torch.models import ntuple_big
    from gym2048_tpu_torch.train import td

    from benchmark.entries.td_chunk import sample_steps
    from benchmark.reference.ntuple import Network

    entry = td_entry(tiny, seed)
    k, steps = entry.traffic["tc_every"], entry.traffic["chunk_steps"]
    sample = sample_steps(entry.config, entry.state, steps, k)
    lookups, greedy = [], []
    spans = [tracing.Span(td, "_greedy_batch", "greedy",
                          lambda args, kwargs, out: greedy.append((out[1], out[4]))),
             tracing.Span(ntuple_big, "gather_values", "gather_values",
                          lambda args, kwargs, out: lookups.append(args[1]))]
    for s in spans:
        s.recording = True
    with tracing.installed(spans):
        entry.unit()  # the next chunk, from the state the sample read
    assert len(lookups) == len(greedy) == steps > k
    assert len(sample["lookup_sectors"]) == steps and len(sample["chosen_sectors"]) == steps // k
    # up to the learner's first TC combine, which the sample does not apply
    assert sample["lookup_indices"][:k] == [idx.numel() for idx in lookups[:k]]
    assert sample["lookup_sectors"][:k] == [counts.distinct_sectors(idx) for idx in lookups[:k]]
    c = entry.config
    net = Network(c["tuples"], c["n_vals"], c["thresholds"], torch.device("cpu"))
    chosen = torch.cat([net.indices(after[alive]).reshape(-1) for after, alive in greedy[:k]])
    assert sample["chosen_sectors"][0] == counts.distinct_sectors(chosen) > 0


def test_the_sample_calls_neither_the_search_nor_the_lookup(tiny, monkeypatch):
    from gym2048_tpu_torch.models import ntuple_big
    from gym2048_tpu_torch.train import td

    from benchmark.entries.td_chunk import sample_steps

    entry = td_entry(tiny, 5)
    before = {k: v.clone() for k, v in entry.state.items() if torch.is_tensor(v)}
    gen_state = entry.state["generator"].get_state()

    def refuse(*args, **kwargs):
        raise AssertionError("the sample called the program")

    monkeypatch.setattr(td, "_greedy_batch", refuse)
    monkeypatch.setattr(ntuple_big, "gather_values", refuse)
    k = entry.traffic["tc_every"]
    sample = sample_steps(entry.config, entry.state, 2 * k, k)
    assert len(sample["lookup_sectors"]) == 2 * k and len(sample["chosen_sectors"]) == 2
    assert all(torch.equal(entry.state[k], v) for k, v in before.items())
    assert torch.equal(entry.state["generator"].get_state(), gen_state)


def test_td_byte_readers_on_a_sample():
    """``gather_roofline.td`` and ``step_mfu.td`` from a sample of two steps
    (two TC windows of one step) and a window of 64 steps, a TC combine
    every 2, whose trace recorded 60 lookup launches."""
    sample = {"lookup_indices": [1024, 1024], "lookup_sectors": [100, 140],
              "chosen_sectors": [40, 60]}
    entry = types.SimpleNamespace(sample=sample, traffic={"tc_every": 2})
    ctx = tracing.Context(entry=entry, units=1, steps=64,
                          window_s=0.01, busy_s=0.002, ops=100,
                          op_s={"void gather4_kernel<256>(...)": 1e-4, "other": 1e-3},
                          op_n={"void gather4_kernel<256>(...)": 60, "other": 40})
    per_launch = 8 * 1024 + 32 * 120
    assert layer_metrics.td_gather_roofline(ctx) == pytest.approx(
        100 * 60 * per_launch / counts.HBM_BYTES_PER_S / 1e-4)
    nbytes = 32 * 120 * 64 + 6 * 32 * 50 * 32
    assert layer_metrics.td_step_mfu(ctx) == pytest.approx(
        100 * nbytes / counts.HBM_BYTES_PER_S / 0.01)
    assert layer_metrics.td_step_mfu(tracing.Context(
        entry=types.SimpleNamespace(sample=None, traffic={"tc_every": 2}), units=1, steps=64,
        window_s=0.01,
        busy_s=0.002, ops=0, op_s={})) is None
