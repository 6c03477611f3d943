"""The arithmetic of the per-layer metrics read from the program's own
spans (``gym2048_tpu_torch.utils.profiler``), shared by their small files in
``metrics/``.

The traced run starts ``torch.profiler`` only around its window, and the
program records spans only while a profiler records, so the recorder's
``summary()`` holds the window's spans: each span's calls and its host self
seconds (its time less its child spans'). Each function returns None where
the span recorded nothing, or where the program has no recorder.
"""

from __future__ import annotations


def _summary() -> dict | None:
    try:
        from gym2048_tpu_torch.utils import profiler

        return profiler.summary()
    except (ImportError, AttributeError):  # a program without spans
        return None


def _self_s(summary: dict | None, span: str) -> float | None:
    if summary is None:
        return None
    rec = summary["spans"].get(span)
    return rec["self_s"] if rec and rec["calls"] > 0 else None


def td_host_us(span: str) -> float | None:
    """Host self microseconds of ``span`` a TD step (the ``td.steps`` counter)."""
    summary = _summary()
    s = _self_s(summary, span)
    steps = summary["counters"].get("td.steps", 0) if summary else 0
    if s is None or steps <= 0:
        return None
    return 1e6 * s / steps


def ppo_host_ms(span: str) -> float | None:
    """Host self milliseconds of ``span`` a PPO iteration (the calls of
    ``ppo.iteration``)."""
    summary = _summary()
    s = _self_s(summary, span)
    iters = summary["spans"].get("ppo.iteration", {}).get("calls", 0) if summary else 0
    if s is None or iters <= 0:
        return None
    return 1e3 * s / iters
