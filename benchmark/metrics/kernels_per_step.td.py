"""kernels_per_step.td: device operations a TD step (train/td.py::TDTrainer._chunk_body)."""

from benchmark.layer_metrics import ops_per_step


def read(ctx):
    return ops_per_step(ctx)
