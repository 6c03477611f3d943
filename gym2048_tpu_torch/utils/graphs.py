"""A step on static buffers, run as one CUDA graph replay.

A holder (``train/td.py::_GreedySearch`` and ``_StepTail``,
``train/ppo.py::_SgdGraph``, ``train/ppo.py::_RolloutGraph``) keeps a step's
buffers and ``run``, the step's work on them; a :class:`GraphedStep` runs
it. On a CUDA device the first :data:`WARMUP` steps run eagerly on a side
stream, as real steps (so cuBLAS's and cuDNN's workspaces and the
allocator's blocks are set up before a capture), the next step is captured
once, and it and every later step is a replay of the graph. Elsewhere every
step is a plain call.
"""

from __future__ import annotations

from typing import Callable

import torch

from gym2048_tpu_torch.utils import profiler

WARMUP = 2  # eager steps of a holder before its capture


def kernel_flags() -> tuple:
    """torch's settings that choose the kernels a CUDA graph captures: a
    holder's key holds them, so that a change of any rebuilds its graph."""
    b = torch.backends
    return (torch.are_deterministic_algorithms_enabled(), b.cudnn.deterministic,
            b.cudnn.benchmark, b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)


class GraphedStep:
    """``run(*args)``, a step on a holder's buffers, as one CUDA graph replay
    on ``device`` (see the module's docstring), each replay counted in the
    profiler's ``counter`` and, with ``span``, inside the profiler span
    ``span`` (the capture is not). ``device`` None or not a CUDA device:
    plain calls, nothing captured. The warm-ups count in :attr:`warm`, the
    captured graph is :attr:`graph` (None until the first replay)."""

    def __init__(self, run: Callable, counter: str, device: torch.device | None,
                 span: str | None = None):
        self.run, self.counter, self.span = run, counter, span
        self.warm = 0
        self.side = (torch.cuda.Stream(device)
                     if device is not None and device.type == "cuda" else None)
        self.graph = None

    @property
    def captures(self) -> bool:
        """Whether the steps after the warm-ups are graph replays."""
        return self.side is not None

    @property
    def warming(self) -> bool:
        """Whether the next step is one of the first :data:`WARMUP`."""
        return self.warm < WARMUP

    def eager(self, fn: Callable, *args):
        """A warm-up step: ``fn(*args)`` (``run`` or the holder's eager step)
        on the side stream, after the current stream's work and before its
        next -> ``fn``'s result."""
        self.warm += 1
        if self.side is None:
            return fn(*args)
        current = torch.cuda.current_stream(self.side.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            out = fn(*args)
        current.wait_stream(self.side)
        return out

    def replay(self, *args) -> None:
        """A step after the warm-ups: the graph's replay, captured from
        ``run(*args)`` at the first (the capture runs nothing); off the card
        ``run(*args)``."""
        if self.side is None:
            self.run(*args)
            return
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.run(*args)
            self.graph = graph
        if self.span is None:
            self.graph.replay()
        else:
            with profiler.span(self.span):
                self.graph.replay()
        profiler.count(self.counter, 1)
