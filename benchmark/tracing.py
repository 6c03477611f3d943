"""The traced run: ``torch.profiler`` over a short window of whole units,
and the reduction of its trace to the numbers the per-layer metrics read.

The program's own spans (``gym2048_tpu_torch.utils.profiler``) lie on the
trace's host timeline, and each device operation counts for every span
whose host range, on the same thread, encloses the runtime call that
launched it: ``cudaLaunchKernel`` or ``cudaMemcpyAsync`` for an eager
operation, ``cudaGraphLaunch`` for each kernel of a CUDA graph replay
(Kineto gives a call and what it launched one correlation id).

A :class:`Span` replaces one attribute of the program (a function in a
module, or a method on an object) that the caller looks up when it calls
it, with a wrapper that opens a ``torch.profiler.record_function`` range of
the span's name and, while the window records, hands the call's arguments
and result to the span's ``keep`` function. Only the agent's entry, whose
cell is out of ``BENCHMARK.json``, still installs one; the wrappers exist
only in the traced run and do no device work.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

from benchmark import program_spans


class Span:
    """A span ``name`` around ``owner.attr`` (see the module docstring)."""

    def __init__(self, owner, attr: str, name: str, keep=None):
        self.owner, self.attr, self.name, self.keep = owner, attr, name, keep
        self.recording = False
        self._orig = None

    def install(self) -> None:
        orig = self._orig = getattr(self.owner, self.attr)
        span = self

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(span.name):
                out = orig(*args, **kwargs)
            if span.recording and span.keep is not None:
                span.keep(args, kwargs, out)
            return out

        setattr(self.owner, self.attr, wrapper)

    def uninstall(self) -> None:
        setattr(self.owner, self.attr, self._orig)


@contextlib.contextmanager
def installed(spans: list[Span]):
    for s in spans:
        s.install()
    try:
        yield
    finally:
        for s in reversed(spans):
            s.uninstall()


@dataclasses.dataclass
class Context:
    """What the per-layer metrics read (``metrics/<name>.py``)."""

    entry: object
    units: int
    steps: float          # the entry's lockstep steps (TD steps, moves, env steps a env)
    window_s: float
    busy_s: float
    ops: int              # device operations (kernels, copies, fills) in the window
    op_s: dict            # device seconds by operation name
    op_n: dict = dataclasses.field(default_factory=dict)  # launches by operation name
    # device seconds by the names of the spans that enclose the launching call
    by_spans: dict = dataclasses.field(default_factory=dict)
    stash: dict = dataclasses.field(default_factory=dict)  # the ``keep`` functions' records
    breakdown: dict = dataclasses.field(default_factory=dict)

    def op_seconds(self, needle: str) -> float:
        """Device seconds of the operations whose name contains ``needle``."""
        return sum(s for n, s in self.op_s.items() if needle in n)

    def op_launches(self, needle: str) -> int:
        """Launches of the operations whose name contains ``needle``."""
        return sum(k for n, k in self.op_n.items() if needle in n)

    def span_device_s(self, *spans: str) -> float:
        """Device seconds of the operations launched inside any of
        ``spans``, each operation once."""
        return sum(s for inside, s in self.by_spans.items() if set(inside) & set(spans))


def short_name(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::"):
        name = name.replace(noise, "")
    return name[:100]


def _union_s(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Length of the union of intervals and the merged intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def _gap_owners(gaps, cpu: list[tuple]) -> dict[str, float]:
    """Seconds of device idle gaps by the deepest host event running at each
    gap's middle on the busiest host thread (``python`` where none ran).
    ``cpu`` holds ``(start, end, name, thread)`` in nanoseconds."""
    if not cpu:
        return {}
    counts: dict[int, int] = {}
    for e in cpu:
        counts[e[3]] = counts.get(e[3], 0) + 1
    main = max(counts, key=counts.get)
    evs = sorted(e[:3] for e in cpu if e[3] == main)
    out: dict[str, float] = {}
    stack: list[tuple] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(evs) and evs[i][0] <= mid:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        owner = stack[-1][2] if stack else "python"
        out[owner] = out.get(owner, 0.0) + (b - a) / 1e9
    return out


def _raw_events(prof, span_names: set[str]):
    """``(device, cpu, by_spans)`` from the profiler's raw Kineto events, in
    nanoseconds: device ``(start, end, name)``, host ``(start, end, name,
    thread)``, and device seconds by the sorted names of the spans that
    enclose each operation's launching call (see the module docstring).

    A device operation carries the correlation id of its runtime call and
    the linked id of the innermost profiled host operation open at that
    call. A runtime call (``cuda*``, ``cu*``) carries the same two, a
    profiled operation only its own id, in another numbering than the
    calls'. The call's start places the operation in time, the linked
    operation's thread in a thread (a runtime call's own thread id is
    CUPTI's, not the profiler's). An
    operation whose call is missing is placed at its linked operation's
    start, which lies inside the same spans. Reading the raw events skips
    building torch's event tree, which takes minutes for a window of a
    million operations."""
    from torch.autograd import DeviceType

    device, cpu, launched = [], [], []
    ops: dict[int, tuple[int, int]] = {}  # profiled host operation: id -> (start, thread)
    calls: dict[int, int] = {}            # runtime call: correlation id -> start
    spans: dict[str, list[tuple[int, int, int]]] = {n: [] for n in span_names}
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name in span_names:
                continue
            device.append((start, end, name))
            launched.append((e.correlation_id(), e.linked_correlation_id(), end - start))
        elif e.device_type() == DeviceType.CPU:
            thread = e.start_thread_id()
            cpu.append((start, end, name, thread))
            if e.linked_correlation_id() or name.startswith("cu"):
                calls[e.correlation_id()] = start
            elif e.correlation_id():
                ops[e.correlation_id()] = (start, thread)
            if name in spans:
                spans[name].append((start, end, thread))
    spans = {n: sorted(ivs) for n, ivs in spans.items() if ivs}
    starts = {n: [iv[0] for iv in ivs] for n, ivs in spans.items()}
    by_spans: dict[tuple[str, ...], float] = {}
    for corr, linked, dur in launched:
        if linked not in ops:
            continue
        t, thread = ops[linked]
        t = calls.get(corr, t)
        inside = []
        for n, ivs in spans.items():
            k = bisect.bisect_right(starts[n], t) - 1
            if k >= 0 and ivs[k][1] >= t and ivs[k][2] == thread:
                inside.append(n)
        key = tuple(sorted(inside))
        by_spans[key] = by_spans.get(key, 0.0) + dur / 1e9
    return device, cpu, by_spans


def reduce_profile(prof, span_names: set[str]) -> dict:
    """Busy seconds, operation counts and times, device seconds by span and
    the breakdown of one profiled window."""
    device, cpu, by_spans = _raw_events(prof, span_names)
    op_s: dict[str, float] = {}
    op_n: dict[str, int] = {}
    for a, b, name in device:
        op_s[name] = op_s.get(name, 0.0) + (b - a) / 1e9
        op_n[name] = op_n.get(name, 0) + 1
    busy_ns, merged = _union_s([(a, b) for a, b, _ in device])
    gaps = [(merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)]
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    owners = sorted(_gap_owners(gaps, cpu).items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "ops": len(device), "op_s": op_s, "op_n": op_n,
            "by_spans": by_spans,
            "breakdown": {"device_ops": [[short_name(n), s] for n, s in top],
                          "idle_gaps": [[short_name(n), s] for n, s in owners]}}


def traced_window(entry) -> Context:
    """Profile the entry's traced window (``entry.traced_units``) with its
    spans installed, and reduce the trace over the entry's spans and the
    program's spans that the window recorded."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans = entry.spans()
    prof = profile(activities=activities)
    clock: dict[str, float] = {}

    def start():
        entry.sync()
        for s in spans:
            s.recording = True
        prof.start()
        clock["t0"] = time.perf_counter()

    def stop():
        entry.sync()
        clock["t1"] = time.perf_counter()
        prof.stop()
        for s in spans:
            s.recording = False

    with installed(spans):
        units, steps = entry.traced_units(start, stop)
    red = reduce_profile(prof, {s.name for s in spans} | program_spans.recorded())
    return Context(entry=entry, units=units, steps=steps, window_s=clock["t1"] - clock["t0"],
                   busy_s=red["busy_s"], ops=red["ops"], op_s=red["op_s"], op_n=red["op_n"],
                   by_spans=red["by_spans"], stash=entry.stash, breakdown=red["breakdown"])
