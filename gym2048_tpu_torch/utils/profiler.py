"""Profiling and tracing (counterpart of ``gym2048_tpu/utils/profiler.py``).

``trace`` profiles a block with ``torch.profiler`` and writes a Chrome
trace. ``span`` and ``count`` are the program's own spans and counters at
its layer boundaries (the TD step's and the PPO iteration's phases), kept
in memory by one :class:`Recorder`; ``summary`` gives each span's calls,
total and self seconds, and the counters.

The switch is the profiler itself. While no ``torch.profiler`` records,
``span`` checks the profiler's flag and returns a shared no-op context, and
``count`` checks it and returns: no allocation, no profiler range, no clock
read. While a profiler records, a span opens a profiler range of its name,
so it lies on the trace's host timeline and names the host work inside it,
and appends one record: its name, the index of the enclosing span (-1 at the
top), the unit id it shares with the spans of one chunk or iteration, and
its start and end in Unix-epoch nanoseconds (``time.time_ns``), the clock of
the profiler's own events. The range is torch's fast one
(``_RecordFunctionFast``), not ``record_function``: it costs about a third
as much (3.8 against 11.3 us a span on an H100's host), and it is no user
annotation, so the device's timeline gets no range of it that a reader of
device events could take for work. On or off, spans and counters do no
device work, no host sync and no random draw, so a CUDA graph may capture
code that holds them. They keep what every window records until
``clear()``; the recorder serves the thread that opens the spans.

A program span's name is dotted (``td.greedy``, ``ppo.forward``) and is no
other range's name: a reader that matches the trace's events by name would
take two nested ranges of one name for one.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch

profiler_enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the enclosed block and write its trace to
    ``<log_dir>/trace_<pid>_<ns>.json`` (default ``log_dir``: ``torch-trace``
    in the temporary directory), a Chrome trace that Perfetto opens, with the
    program's spans on its timeline. Yields the ``torch.profiler.profile``
    object (``key_averages()``); its ``trace_path`` attribute names the file
    once the block has ended."""
    log_dir = Path(log_dir if log_dir is not None
                   else Path(tempfile.gettempdir()) / "torch-trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    with prof:
        yield prof
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    prof.trace_path = path


class _Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("recorder", "name", "unit", "prange", "entry")

    def __init__(self, recorder: Recorder, name: str, unit):
        self.recorder, self.name, self.unit = recorder, name, unit

    def __enter__(self):
        records, stack = self.recorder.records, self.recorder.stack
        parent = stack[-1][0] if stack else -1
        unit = self.unit if self.unit is not None or parent < 0 else records[parent][2]
        self.prange = _range(self.name)
        self.prange.__enter__()
        # stamped inside the range: the profiler stamps its event inside the
        # range's enter and exit too, after the set-up that a window's first
        # event pays (milliseconds after a garbage collection)
        self.entry = [self.name, parent, unit, time.time_ns(), None]
        stack.append((len(records), self.entry))
        records.append(self.entry)
        return self

    def __exit__(self, *exc):
        self.entry[4] = time.time_ns()
        stack = self.recorder.stack
        if stack and stack[-1][1] is self.entry:
            stack.pop()
        self.prange.__exit__(*exc)
        return False


def _covered_ns(start: int, end: int, intervals: list[tuple[int, int]]) -> int:
    """Nanoseconds of ``[start, end]`` that the union of ``intervals`` covers."""
    covered, reach = 0, start
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, end)
        if b > a:
            covered += b - a
            reach = b
    return covered


class Recorder:
    """Spans and counters in memory: ``records`` holds ``[name, parent,
    unit, start_ns, end_ns]`` a span (``end_ns`` None while it is open),
    ``counters`` the counts by name."""

    def __init__(self) -> None:
        self.records: list[list] = []
        self.stack: list[tuple[int, list]] = []
        self.counters: dict[str, int] = {}

    def span(self, name: str, unit=None):
        """A span ``name`` over the ``with`` block; ``unit`` is the unit id
        (by default the enclosing span's). A no-op unless a profiler
        records."""
        if not profiler_enabled():
            return _OFF
        return _Span(self, name, unit)

    def count(self, name: str, n: int) -> None:
        """Add the host integer ``n`` to the counter ``name`` while a
        profiler records."""
        if profiler_enabled():
            self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> dict:
        """``{"spans": {name: {"calls", "total_s", "self_s"}}, "counters":
        {name: n}}`` over the closed spans: a span's self time is its total
        less the part of its interval that its direct children cover."""
        children: dict[int, list[tuple[int, int]]] = {}
        for name, parent, _, start, end in self.records:
            if end is not None and parent >= 0:
                children.setdefault(parent, []).append((start, end))
        spans: dict[str, dict] = {}
        for i, (name, _, _, start, end) in enumerate(self.records):
            if end is None:
                continue
            s = spans.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
            s["calls"] += 1
            s["total_s"] += (end - start) / 1e9
            s["self_s"] += (end - start - _covered_ns(start, end, children.get(i, []))) / 1e9
        return {"spans": spans, "counters": dict(self.counters)}

    def clear(self) -> None:
        """Forget every record and counter."""
        self.records.clear()
        self.stack.clear()
        self.counters.clear()


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
summary = RECORDER.summary
clear = RECORDER.clear
