"""The arithmetic of the per-layer metrics, shared by the small files in
``metrics/`` (one a metric, each naming one of these functions). Every
function reads a :class:`~benchmark.tracing.Context` and returns a number,
or None where the traced window holds nothing to read: a share of a
roofline or a peak is never reported as 0, and a window with no device
trace (a run on the CPU) gives no device metric.
"""

from __future__ import annotations

import statistics

import torch

from benchmark import counts, program_spans

GATHER_KERNELS = ("gather4_kernel", "gather1_kernel")


def device_idle(ctx) -> float | None:
    """Share of the traced window in which no operation ran on the card (%)."""
    if ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def ops_per_step(ctx) -> float | None:
    """Device operations (kernels, copies, fills) a lockstep step."""
    if ctx.ops == 0 or ctx.steps <= 0:
        return None
    return ctx.ops / ctx.steps


def span_device_share(ctx, span: str) -> float | None:
    """The device time of the operations launched inside ``span`` as a
    share of the window's busy time (%)."""
    s = ctx.span_device_s(span)
    if s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * s / ctx.busy_s


def span_device(ctx, spans: tuple[str, ...], scale: float) -> float | None:
    """``scale`` times the device seconds of the operations launched inside
    any of the program's ``spans`` (each once), a TD step for ``td.`` spans
    or a PPO iteration for ``ppo.`` spans (``program_spans.units``)."""
    s, n = ctx.span_device_s(*spans), program_spans.units(spans[0])
    if s <= 0 or n <= 0:
        return None
    return scale * s / n


def _gather_kernel_s(ctx) -> float:
    return sum(ctx.op_seconds(k) for k in GATHER_KERNELS)


def gather_roofline(ctx) -> float | None:
    """The lookup kernel's least time by bytes (each index read and each
    value written once, each distinct 32-byte table sector read once) over
    its kernel time, summed over the window's launches as the entry's
    ``gather_values`` span kept them (%)."""
    launches = [idx for _, idx in ctx.stash.get("gather_idx", [])]
    kernel_s = _gather_kernel_s(ctx)
    if not launches or kernel_s <= 0:
        return None
    least = sum(counts.bytes_time_s(counts.gather_bytes(idx.numel(), counts.distinct_sectors(idx)))
                for idx in launches)
    return 100.0 * least / kernel_s


def _td_sample(ctx) -> dict | None:
    return getattr(ctx.entry, "sample", None)


def td_gather_roofline(ctx) -> float | None:
    """The lookup kernel's least time by bytes (as :func:`gather_roofline`
    counts them) over its kernel time (%): the bytes of one launch are the
    mean of the TD entry's sampled steps (a step's lookup is one launch),
    times the kernel's launches that the trace recorded."""
    sample = _td_sample(ctx)
    launches = sum(ctx.op_launches(k) for k in GATHER_KERNELS)
    kernel_s = _gather_kernel_s(ctx)
    if not sample or launches <= 0 or kernel_s <= 0:
        return None
    per_launch = statistics.fmean(counts.gather_bytes(n, sectors) for n, sectors in
                                  zip(sample["lookup_indices"], sample["lookup_sectors"]))
    return 100.0 * launches * counts.bytes_time_s(per_launch) / kernel_s


def td_step_mfu(ctx) -> float | None:
    """The TD window's least time over its measured time (%). Its FLOPs are
    negligible, so bytes bound it, counted from the TD entry's sampled
    steps (the sample's mean a step or a TC window, times the window's
    steps or TC combines): each step's lookup, the distinct sectors of its
    four afterstates' entries; each TC combine (one every ``tc_every``
    steps), the read and write of ``table``, ``tc_e`` and ``tc_a`` over the
    distinct sectors that the window's chosen afterstates touch."""
    sample = _td_sample(ctx)
    if not sample or not sample["chosen_sectors"] or ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    combines = int(ctx.steps) // int(ctx.entry.traffic["tc_every"])
    nbytes = counts.SECTOR_BYTES * statistics.fmean(sample["lookup_sectors"]) * ctx.steps
    nbytes += 6 * counts.SECTOR_BYTES * statistics.fmean(sample["chosen_sectors"]) * combines
    return 100.0 * counts.bytes_time_s(nbytes) / ctx.window_s


def agent_step_mfu(ctx) -> float | None:
    """The agent window's least time over its measured time (%): for each
    lockstep move, the distinct table sectors that all its searches' leaves
    read, once (the FLOPs and the boards' bytes are negligible)."""
    lookups = ctx.stash.get("gather_idx", [])
    if not lookups or ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    by_move: dict[int, list] = {}
    for move, idx in lookups:
        by_move.setdefault(move, []).append(idx.reshape(-1))
    nbytes = sum(counts.SECTOR_BYTES * counts.distinct_sectors(torch.cat(v))
                 for v in by_move.values())
    return 100.0 * counts.bytes_time_s(nbytes) / ctx.window_s


def ppo_step_mfu(ctx) -> float | None:
    """The model's forward and backward FLOPs of the window's iterations
    over the window's time, against the dense peak of the cell's compute
    dtype (%)."""
    e = ctx.entry
    if ctx.window_s <= 0 or ctx.units <= 0 or ctx.busy_s <= 0:
        return None
    flops = ctx.units * counts.ppo_iteration_flops(e.cfg.n_envs, e.cfg.n_steps, e.cfg.n_epochs,
                                                   e.cfg.filters, e.cfg.residual_blocks)
    return 100.0 * flops / ctx.window_s / counts.PEAK_FLOPS[e.traffic["peak"]]
