"""Nothing the benchmark imports or runs has ``jax``, ``jaxlib``, ``flax`` or
``gym2048_tpu`` as its top-level module name (compared whole: the program,
``gym2048_tpu_torch``, begins with the JAX package's name), and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import BENCH, REPO


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in {"__future__", "torch", "functools", "itertools", "benchmark"}, (
                path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_the_whole_name_is_compared(monkeypatch):
    for name in ("gym2048_tpu_torch.fake", "jaxish", "flax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gym2048_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jax.fake", object())
    assert harness.forbidden_modules() == ["gym2048_tpu.fake", "jax.fake"]


CHILD = """
import json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from benchmark import harness
from benchmark.tests.conftest import make_tiny_root
root, repo = make_tiny_root(Path({tmp!r}))
for cell in ("td-4x6-tc-tiny", "agent-4x6-d3-tiny", "ppo-sb3-f32-tiny"):
    harness.run_cell(cell, 3, 0.2, False, device="cpu", root=root, repo=repo)
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_forbidden_module(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # nothing preloaded into the child
    out = subprocess.run([sys.executable, "-c", CHILD.format(repo=str(REPO), tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_or_without_the_program_no_result_is_printed(tmp_path):
    # here: no CUDA; in a copy holding only BENCHMARK.json and the benchmark,
    # not even the program
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "td-4x6-tc",
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
