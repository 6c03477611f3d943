"""Profiling / tracing hooks (counterpart of ``gym2048_tpu/utils/profiler.py``).

A context manager around ``torch.profiler`` that captures CPU and, where
there is a card, CUDA activity into a Chrome/Perfetto trace file; named
annotations for the hot phases; and a steps/s meter.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the enclosed block and write its trace to
    ``<log_dir>/trace_<pid>_<ns>.json`` (default ``log_dir``: ``torch-trace``
    in the temporary directory), a Chrome trace that Perfetto opens. Yields
    the ``torch.profiler.profile`` object (``key_averages()``); its
    ``trace_path`` attribute names the file once the block has ended."""
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


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class StepsPerSecond:
    """Throughput meter: call ``update(n_steps)`` after each unit of work.

    ``rate()`` gives overall steps/s, ``window_rate()`` the rate since the
    last ``mark()``. CUDA work is queued, so the caller synchronises the
    device (``torch.cuda.synchronize()``) before reading a rate, or the rate
    counts steps queued, not steps done.
    """

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.total = 0
        self._mark_t = self.t0
        self._mark_total = 0

    def update(self, n_steps: int) -> None:
        self.total += int(n_steps)

    def mark(self) -> None:
        self._mark_t = time.perf_counter()
        self._mark_total = self.total

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.total / dt if dt > 0 else 0.0

    def window_rate(self) -> float:
        dt = time.perf_counter() - self._mark_t
        n = self.total - self._mark_total
        return n / dt if dt > 0 else 0.0
