"""The arithmetic of the per-layer metrics, shared by the small files in
``metrics/`` (one a metric, each naming one of these functions). Every
function reads a :class:`~benchmark.tracing.Context` and returns a number,
or None where the traced window holds nothing to read: a share of a
roofline or a peak is never reported as 0, and a window with no device
trace (a run on the CPU) gives no device metric.
"""

from __future__ import annotations

import torch

from benchmark import counts

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
    """The device time of the kernels launched inside ``span`` as a share of
    the window's busy time (%)."""
    s = ctx.span_device_s.get(span, 0.0)
    if s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * s / ctx.busy_s


def span_host_share(ctx, span: str) -> float | None:
    """The host seconds inside ``span`` as a share of the window (%)."""
    s = ctx.span_host_s.get(span, 0.0)
    if s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * s / ctx.window_s


def _gather_kernel_s(ctx) -> float:
    return sum(ctx.op_seconds(k) for k in GATHER_KERNELS)


def gather_roofline(ctx) -> float | None:
    """The lookup kernel's least time by bytes (each index read and each
    value written once, each distinct 32-byte table sector read once) over
    its kernel time, summed over the window's launches (%)."""
    launches = [idx for _, idx in ctx.stash.get("gather_idx", [])]
    kernel_s = _gather_kernel_s(ctx)
    if not launches or kernel_s <= 0:
        return None
    least = sum(counts.bytes_time_s(counts.gather_bytes(idx.numel(), counts.distinct_sectors(idx)))
                for idx in launches)
    return 100.0 * least / kernel_s


def _network(ctx):
    from benchmark.reference.ntuple import Network

    c = ctx.entry.config
    return Network(c["tuples"], c["n_vals"], c["thresholds"], ctx.entry.device)


def td_step_mfu(ctx) -> float | None:
    """The TD window's least time over its measured time (%). Its FLOPs are
    negligible, so bytes bound it: each step's lookups (the distinct sectors
    of its four afterstates' entries), and at every TC combine the read and
    write of ``table``, ``tc_e`` and ``tc_a`` over the distinct sectors the
    window's updates touched (the update of step t is the afterstate chosen
    at step t - 1; the first window's first update, chosen before the
    traced window, is left out)."""
    lookups = ctx.stash.get("gather_idx", [])
    greedy = ctx.stash.get("greedy", [])
    if not lookups or ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    nbytes = sum(counts.SECTOR_BYTES * counts.distinct_sectors(idx) for _, idx in lookups)
    net = _network(ctx)
    k = int(ctx.entry.traffic["tc_every"])
    for w in range(len(greedy) // k):
        chosen = [greedy[t] for t in range(max(w * k - 1, 0), w * k + k - 1)]
        idx = torch.cat([net.indices(after[alive]).reshape(-1) for after, alive in chosen])
        nbytes += 6 * counts.SECTOR_BYTES * counts.distinct_sectors(idx)
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
