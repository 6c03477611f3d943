"""kernels_per_step.td: device operations a TD step (train/td.py::TDTrainer._scan_steps)."""

from benchmark.layer_metrics import ops_per_step


def read(ctx):
    return ops_per_step(ctx)
