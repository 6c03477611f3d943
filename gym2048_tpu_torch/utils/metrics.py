"""Metrics / observability: JSONL stream + optional TensorBoard (a copy of
``gym2048_tpu/utils/metrics.py``).

Replaces the reference's scattered logging (stdout prints, SB3 TensorBoard
logger with ``rollout/highest_tile``, scores CSVs — SURVEY.md §5) with one
logger: every ``log()`` appends a JSONL record (machine-readable, no deps)
and mirrors scalars to TensorBoard when available (torch's SummaryWriter,
lazily imported; the dependency is optional).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Mapping


class MetricsLogger:
    def __init__(
        self,
        log_dir: str | Path,
        run_name: str = "run",
        tensorboard: bool = True,
    ):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.log_dir / f"{run_name}.jsonl"
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=str(self.log_dir / "tensorboard" / run_name)
                )
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
