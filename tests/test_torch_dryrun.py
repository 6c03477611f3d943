"""The port's multi-rank entry points against the JAX package's:
``gym2048_tpu_torch.entry.dryrun_multichip`` (``__graft_entry__.py``) and
``gym2048_tpu_torch.scaling_bench`` (``scripts/scaling_bench.py``).

* ``dryrun_multichip(1, device="cpu")`` in this process (no process group:
  a one-rank mesh), its 1,048,576-board env at one torch thread, printing
  the JAX function's lines; more ranks than the job has raise.
* Two gloo ranks (tests/torch_dp_worker.py, one launch for both checks,
  started before the in-process test so that the two overlap): the
  module's ``main`` (the forward, then the dry run over both ranks, only
  rank 0 printing), and the scaling bench at a tiny size, whose rows carry
  the JAX script's row keys and ``env_scaling_eff`` and whose ``--md``
  table has the JAX script's columns (the JAX script's own table is
  written into ``tmp_path`` by running its ``main`` with its rates
  stubbed and its ``__file__`` moved there).
"""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_parallel import WORKER, _env, _free_port, _wait

from gym2048_tpu_torch import entry

ROOT = Path(__file__).resolve().parent.parent
# __graft_entry__.py's lines, the numbers left open
DRYRUN_LINES = [
    r"dryrun_multichip 1/3 PPO OK: {n} devices, env batch {envs} sharded over mesh "
    r"\{{'data': {n}, 'model': 1\}}, loss -?\d+\.\d{{4}}",
    r"dryrun_multichip 2/3 TD OK: sharded TC chunk over {n} devices, highest_exp \d+, "
    r"table finite",
    r"dryrun_multichip 3/3 env OK: 1048576 boards sharded over {n} devices, 4 steps, "
    r"score sum \d+",
    r"dryrun_multichip OK: all 3 sub-checks on {n} devices",
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo workers running the ``dryrun`` and ``scaling`` modes, started
    at once; ``two_ranks()`` waits for them and returns ``(their results,
    outdir)``."""
    outdir = tmp_path_factory.mktemp("entry2")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2", port, str(outdir),
                               "dryrun,scaling"], env=_env(), cwd=outdir,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    results = []

    def wait():
        if not results:
            _wait(procs, "2 workers")
            results.extend(torch.load(outdir / f"rank{r}.pt", weights_only=False)
                           for r in range(2))
        return results, outdir

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def check_dryrun_lines(text: str, n: int) -> None:
    lines = [line for line in text.splitlines() if line.startswith("dryrun_multichip")]
    assert len(lines) == len(DRYRUN_LINES), text
    for line, pattern in zip(lines, DRYRUN_LINES):
        assert re.fullmatch(pattern.format(n=n, envs=8 * n), line), line


def test_dryrun_one_rank_in_process(capsys):
    entry.dryrun_multichip(1, device="cpu")
    check_dryrun_lines(capsys.readouterr().out, 1)


def test_dryrun_needs_the_ranks():
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        entry.dryrun_multichip(2, device="cpu")


def test_two_rank_dryrun(two_ranks):
    (a, b), _ = two_ranks()
    assert a["dryrun"].startswith("entry OK: ((256, 4), (256,))\n")
    check_dryrun_lines(a["dryrun"], 2)
    assert b["dryrun"] == ""  # only rank 0 prints


def jax_scaling(monkeypatch, capsys, tmp_path) -> tuple[list[dict], str]:
    """``scripts/scaling_bench.py``'s rows and Markdown, its rates stubbed
    (n devices -> 1000 n) and its ``docs/SCALING.md`` under ``tmp_path``."""
    spec = importlib.util.spec_from_file_location("jax_scaling_bench",
                                                  ROOT / "scripts" / "scaling_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("env_rollout_rate", "ppo_iteration_rate", "td_chunk_rate"):
        monkeypatch.setattr(mod, name, lambda n, *args: 1000.0 * n)
    monkeypatch.setattr(mod, "__file__", str(tmp_path / "scripts" / "scaling_bench.py"))
    monkeypatch.setattr(sys, "argv", ["scaling_bench.py", "--md", "--repeats", "1"])
    capsys.readouterr()
    mod.main()
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    return rows, (tmp_path / "docs" / "SCALING.md").read_text()


def table_head(markdown: str) -> list[str]:
    """The Markdown table's header and rule lines."""
    lines = markdown.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("| devices"))
    return lines[start:start + 2]


def test_two_rank_scaling(two_ranks, monkeypatch, capsys, tmp_path):
    (a, b), outdir = two_ranks()
    rows = [json.loads(line) for line in a["scaling"].splitlines() if line.startswith("{")]
    assert b["scaling"] == ""  # only rank 0 prints
    jax_rows, jax_md = jax_scaling(monkeypatch, capsys, tmp_path)
    assert [r["devices"] for r in jax_rows] == [1, 2, 4, 8]
    assert [r["devices"] for r in rows] == [1, 2]
    for row in rows:
        assert set(row) == set(jax_rows[0]) | {"env_scaling_eff"}
        assert row["env_batch"] == 64 * row["devices"]
        assert min(row["env_steps_per_s"], row["ppo_steps_per_s"], row["td_steps_per_s"]) > 0
        assert row["env_scaling_eff"] == round(
            row["env_steps_per_s"] / (rows[0]["env_steps_per_s"] * row["devices"]), 2)
    md = (outdir / "scaling.md").read_text()
    assert table_head(md) == table_head(jax_md)
    assert len([line for line in md.splitlines() if re.match(r"\| \d", line)]) == 2
