"""Count the instructions each kernel of the built library issues per thread.

The fused step kernels are bound by instruction issue, not by memory: an
H100 SM issues at most four warp instructions per clock, 128 thread
instructions, whatever their type. Their bound is therefore the number of
instructions a thread must run over that rate, and the number is read from
the machine code itself (``cuobjdump -sass`` of the library that
:mod:`gym2048_tpu_torch._build` made), not from the C++ source.

A kernel's code branches on the data (which lines merge, whether a board
resets), so the count taken is the **shortest** control-flow path a thread
can run: every thread runs at least that many instructions, and a warp
issues at least that many for each of its threads, so the count gives a
lower bound on the issue time. For a kernel with one loop the count is
split into the path outside the loop and the path of one iteration, from
the loop's head to its back branch. A guarded ``EXIT`` (the bounds check
of a thread past the end) counts as falling through; ``CALL`` counts as one
instruction without its callee. Both keep the count a lower bound.

    python -m gym2048_tpu_torch._sass [library]

prints the counts of every kernel in the library (default: the built one).
"""

from __future__ import annotations

import dataclasses
import heapq
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")


@dataclasses.dataclass(frozen=True)
class IssueCount:
    """Fewest instructions a thread of one kernel runs: ``outside`` its loop
    (the whole kernel when it has none) and ``per_iteration`` of it."""

    outside: int
    per_iteration: int

    def per_thread(self, iterations: int = 0) -> int:
        return self.outside + iterations * self.per_iteration


def find_cuobjdump() -> str:
    """``cuobjdump`` beside the ``nvcc`` that builds the library, else on
    ``PATH``. Raises if there is none."""
    from gym2048_tpu_torch import _build

    try:
        beside = Path(_build.find_nvcc()).parent / "cuobjdump"
    except RuntimeError:
        beside = None
    if beside is not None and beside.is_file():
        return str(beside)
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found (set CUDA_HOME)")
    return found


def dump(library: Path) -> str:
    """The SASS listing of every kernel in ``library``."""
    done = subprocess.run([find_cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({done.returncode}): {done.stderr}")
    return done.stdout


def short_name(mangled: str) -> str:
    """The last component of an Itanium-mangled name, without its namespaces
    and argument types (``_ZN..17fused_move_kernelEPKi..`` -> ``fused_move_kernel``);
    a name that is not mangled is returned as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    rest, name = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], mangled
    while (m := re.match(r"\d+", rest)):
        length = int(m.group())
        name, rest = rest[m.end():m.end() + length], rest[m.end() + length:]
    return name


def parse(listing: str) -> dict[str, list[tuple[int, str]]]:
    """Kernel name (:func:`short_name`) -> its ``(address, instruction)``
    list, in address order."""
    kernels: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in listing.splitlines():
        fn = _FUNCTION.search(line)
        if fn:
            current = kernels.setdefault(short_name(fn.group(1)), [])
            continue
        ins = _INSTRUCTION.search(line)
        if ins and current is not None:
            current.append((int(ins.group(1), 16), ins.group(2)))
    return kernels


def _successors(code: list[tuple[int, str]]) -> list[list[int]]:
    """Indices each instruction can pass control to."""
    index = {addr: i for i, (addr, _) in enumerate(code)}
    succ = []
    for i, (addr, text) in enumerate(code):
        guarded = text.startswith("@")
        op = text.split()[1 if guarded else 0].split(".")[0]
        if op in ("BRX", "JMX", "JMP"):
            raise ValueError(f"indirect or absolute jump at {addr:#x}: {text}")
        if op == "EXIT" or op == "RET":
            succ.append([i + 1] if guarded else [])
        elif op == "BRA":
            target = index[int(_TARGET.search(text).group(1), 16)]
            # `@P BRA` and `BRA P, target` both branch on a predicate
            conditional = guarded or "," in text
            succ.append([i + 1, target] if conditional else [target])
        else:
            succ.append([i + 1])
    return succ


def _shortest(succ: list[list[int]], start: int, targets: set[int],
              removed: set[int] = frozenset()) -> int | None:
    """Fewest instructions on a path from ``start`` to any of ``targets``,
    both ends counted, avoiding ``removed``; None if there is no path."""
    if start in removed:
        return None
    best = {start: 1}
    heap = [(1, start)]
    while heap:
        cost, i = heapq.heappop(heap)
        if i in targets:
            return cost
        if cost > best[i]:
            continue
        for j in succ[i]:
            if j < len(succ) and j not in removed and cost + 1 < best.get(j, 1 << 60):
                best[j] = cost + 1
                heapq.heappush(heap, (cost + 1, j))
    return None


def issue_count(code: list[tuple[int, str]]) -> IssueCount:
    """The shortest-path count of one kernel (see the module docstring)."""
    succ = _successors(code)
    exits = {i for i, (_, text) in enumerate(code) if text.split()[0] == "EXIT"}
    reach, todo = {0}, [0]
    while todo:
        for j in succ[todo.pop()]:
            if j < len(succ) and j not in reach:
                reach.add(j)
                todo.append(j)
    back = [(i, min(succ[i])) for i in sorted(reach) if min(succ[i], default=i) < i]
    if not back:
        total = _shortest(succ, 0, exits)
        if total is None:
            raise ValueError("no path from the entry to an EXIT")
        return IssueCount(total, 0)
    if len(back) > 1:
        raise ValueError(f"{len(back)} back branches; one loop is supported")
    tail, head = back[0]
    per_iteration = _shortest(succ, head, {tail})
    body = set(range(head, tail + 1))
    # a loop entered on every path leaves nothing outside it to count
    outside = _shortest(succ, 0, exits, removed=body) or 0
    return IssueCount(outside, per_iteration)


def issue_counts(listing: str) -> dict[str, IssueCount]:
    """:func:`issue_count` of every kernel in a ``cuobjdump -sass`` listing."""
    return {name: issue_count(code) for name, code in parse(listing).items()}


def main(argv: list[str]) -> int:
    from gym2048_tpu_torch import _build

    library = Path(argv[0]) if argv else _build.build()
    for name, count in issue_counts(dump(library)).items():
        print(f"{name}: {count.outside} outside a loop, "
              f"{count.per_iteration} per iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
