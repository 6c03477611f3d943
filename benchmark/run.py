"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's number of cards.
With ``--trace 0`` it times whole units of the cell's entry for ``--seconds``
and reports the cell's end-to-end metrics; with ``--trace 1`` it profiles a
short window of whole units and reports the cell's per-layer metrics. Every
run then frees the program's state and checks what the program produced in
its first units against the plain reference (``benchmark/reference/``).

The last lines on standard error are the numbers compared, each beside its
limit; the last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``. Without CUDA, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": REPO / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": REPO / "build" / "triton",
          "CUDA_CACHE_PATH": REPO / "build" / "nv_compute_cache"}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path[0] = str(REPO)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"run: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
