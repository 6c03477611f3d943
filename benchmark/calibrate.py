"""Readings that set a cell's limits: the program's, and its control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control]

For each seed, in one process: the cell's set-up (the program's first
units, as every run makes them), then the check's numbers against the
plain reference, with no timed window: every reading, also those that the
cell does not compare. With ``--control`` the entry's
control stands in the program's place: the plain reference computed in the
precision below the one that the configuration states, or the program's
own path in that precision where it has one (``Entry.control``); with
``--fault <name>`` a fault of ``faults.py`` is planted in it. Prints one
JSON line a seed and, last, the largest reading of each number.

The limits in ``workloads/<cell>.json`` lie between the largest reading of
sound runs over a dozen seeds or more and the smallest of the control's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None,
                        help="a function of benchmark/faults.py planted in the program")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path[0] = str(REPO)
    from benchmark.run import CACHES

    for key, path in CACHES.items():
        os.environ[key] = str(path)
    import torch

    from benchmark import faults, harness

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    worst: dict[str, float] = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        plant = getattr(faults, args.fault)() if args.fault else contextlib.nullcontext()
        with plant:
            entry = harness.load_entry(cell)(cell, seed, dev)
            if args.control:
                entry.control()
            else:
                entry.setup()
                entry.calibration_units()
                entry.release()
        t1 = time.perf_counter()
        entry.check()
        readings = entry.readings_read
        for k, v in readings.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "readings": readings, "program_s": t1 - t0,
                          "check_s": time.perf_counter() - t1}), flush=True)
        del entry
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "control": args.control, "fault": args.fault,
                      "largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
