"""What every entry of the benchmark provides (``entries/<name>.py``
defines a class ``Entry`` on top of :class:`Entry`).

An entry drives one unit of the program's own loop at a time: a TD chunk, a
PPO iteration, a ``play_policy`` call. The harness calls, in order:

* ``setup()``: build the program's objects from the cell's configuration,
  traffic and ``--seed``, and warm every shape the traffic uses; the first
  units, which the check follows, run here through ``unit()``;
* ``unit()`` again and again (the timed or traced window): one unit,
  ending with the host read of the program's own loop; returns its work;
* ``release()``: drop the program's state, so that the reference, which
  runs last, does not set the process's memory peak;
* ``check()``: the numbers compared, ``[{"name", "value", "limit"}]``,
  each value a reading of the program against the plain reference.

In a traced run the harness installs ``spans()`` and calls
``traced_units(start, stop)``, which runs whole units between ``start()``
and ``stop()`` and returns ``(units, steps)``.
"""

from __future__ import annotations

import statistics

import torch


def leaf_gap(program: dict[str, float], reference: dict[str, float]) -> float:
    """The worst leaf's gap between two sets of norms: ``|program - reference|``
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    median = statistics.median(reference.values())
    return max(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
               for k in reference)


def reserve(device: torch.device, nbytes: int) -> None:
    """Grow the caching allocator's pool by ``nbytes`` before a traced
    window, so that what the spans keep comes out of it and no
    ``cudaMalloc`` runs inside the window."""
    if device.type == "cuda":
        torch.empty(nbytes, dtype=torch.uint8, device=device)  # freed into the pool at once


def norm64(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach(), dtype=torch.float64))


class Entry:
    rate_metric = ""
    rate_unit = ""

    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cell = cell
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.limits = cell["limits"]
        self.seed = int(seed)
        self.device = device
        self.stash: dict[str, list] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spans(self) -> list:
        return []

    def traced_units(self, start, stop) -> tuple[int, float]:
        """``traffic["trace_units"]`` whole units between ``start()`` and
        ``stop()``; returns ``(units, steps)``."""
        n = int(self.traffic["trace_units"])
        start()
        for _ in range(n):
            self.unit()
        stop()
        return n, n * self.steps_per_unit

    def calibration_units(self) -> None:
        """Units that a calibration run adds after the set-up, for entries
        whose check reads the window's answers."""

    def numbers(self, readings: dict[str, float]) -> list[dict]:
        """The readings that the cell compares (those it gives a limit),
        beside their limits; all of them stay in ``self.readings_read``."""
        self.readings_read = dict(readings)
        return [{"name": k, "value": float(v), "limit": float(self.limits[k])}
                for k, v in readings.items() if k in self.limits]
