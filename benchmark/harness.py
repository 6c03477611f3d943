"""The benchmark's driver: find a cell's files by name, set it up, time it,
trace it, check it, and build the result line.

A cell is ``workloads/<cell>.json``: its configuration's name, its entry's
name, its traffic and the limits of its check. The configuration is
``configs/<config>.json``, the entry ``entries/<entry>.py`` (a class
``Entry``), each per-layer metric ``metrics/<metric>.py`` (a function
``read(ctx)``). Which per-layer metrics a cell reports is read from
``BENCHMARK.json`` at the repository root: those that list the cell under
``workloads``, and those without that key that move an end-to-end metric
the cell reports. So a new cell, configuration or metric is a new file and
an entry in ``BENCHMARK.json``, and no file here changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gym2048_tpu")  # whole top-level names


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed from the run's ``--seed`` and a tag: one stream per use."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_file(path: Path, label: str):
    """Import the Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no {label} file {path}")
    name = "benchmark_" + re.sub(r"\W", "_", f"{label}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration loaded under ``"config"``."""
    cell = load_json(root / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_name"] = cell["config"]
    cell["config"] = load_json(root / "configs" / f"{cell['config']}.json")
    return cell


def load_entry(cell: dict, root: Path = ROOT):
    """The class ``Entry`` of the cell's entry file."""
    return _load_file(root / "entries" / f"{cell['entry']}.py", "entry").Entry


def load_metric(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of the per-layer metric ``name``."""
    return _load_file(root / "metrics" / f"{name}.py", "metric").read


def per_layer_of(cell_name: str, end_to_end: set[str], spec: dict) -> list[dict]:
    """The per-layer metrics of ``BENCHMARK.json`` that the cell reports."""
    out = []
    for m in spec.get("per_layer", []):
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in end_to_end:
            out.append(m)
    return out


def benchmark_spec(repo: Path = REPO) -> dict:
    path = repo / "BENCHMARK.json"
    return load_json(path) if path.is_file() else {}


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of it
    (``/proc``), on the boot clock; the time since this module was imported
    where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def timed_window(entry, seconds: float) -> tuple[int, float, float]:
    """Whole units of ``entry`` from now until the first unit boundary at or
    after ``seconds``: ``(units, work, seconds)``. Each unit ends with the
    host read its program's own loop makes."""
    sync = entry.sync
    sync()
    t0 = time.perf_counter()
    units, work = 0, 0.0
    while True:
        work += entry.unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return units, work, time.perf_counter() - t0


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, repo: Path = REPO) -> dict:
    """One run of the cell ``name``: the result line's object, with the
    numbers compared under ``"checks"``."""
    import torch

    from benchmark import tracing

    cell = load_cell(name, root)
    spec = benchmark_spec(repo)
    dev = torch.device(device)
    entry = load_entry(cell, root)(cell, seed, dev)
    entry.setup()
    entry.sync()
    setup_s = process_age_s()
    metrics: dict[str, dict] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell.get("chips", 1))}
    breakdown = None
    if trace:
        ctx = tracing.traced_window(entry)
        for m in per_layer_of(name, {entry.rate_metric, "setup_s"}, spec):
            value = load_metric(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = ctx.busy_s
        device_info["window_s"] = ctx.window_s
        breakdown = ctx.breakdown
        units = ctx.units
    else:
        units, work, secs = timed_window(entry, seconds)
        metrics[entry.rate_metric] = {"value": work / secs, "unit": entry.rate_unit}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                        if dev.type == "cuda" else 0)
    entry.release()
    checks = entry.check()
    correct = all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result
