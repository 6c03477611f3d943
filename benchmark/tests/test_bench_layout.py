"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding cells, configurations, entries and metrics by name."""

from __future__ import annotations

import json
import re
import shutil

from benchmark import harness
from benchmark.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [e["why"] for e in SPEC["configs"] + SPEC["workloads"]]
    texts += [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_every_cell_has_its_files_and_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in configs.values():
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs and w["traffic"] == w["name"]
        cell = harness.load_cell(w["name"])
        assert cell["config_name"] == w["config"]
        entry = harness.load_entry(cell)
        reported = {m for m, spec in e2e.items()
                    if "workloads" not in spec or w["name"] in spec["workloads"]}
        assert "setup_s" in reported and entry.rate_metric in reported and len(reported) == 2
        layer = harness.per_layer_of(w["name"], reported, SPEC)
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in reported
            assert callable(harness.load_metric(m["name"]))
    assert {c["config"] for c in SPEC["workloads"]} == set(configs)


def test_one_layer_name_a_layer():
    by_layer: dict[str, set] = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # the kernel metrics of one kernel name one layer, letter for letter
    assert len(by_layer["gather_roofline"]) == 1
    assert len(by_layer["device_idle"]) == 1


def test_new_cell_config_entry_and_metric_are_found_by_adding_files_only(tmp_path):
    root = tmp_path / "bench"
    for d in ("entries", "metrics", "configs", "workloads"):
        shutil.copytree(BENCH / d, root / d)
    before = {p.relative_to(root) for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "new-config.json").write_text(json.dumps({"n_vals": 3}))
    (root / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "new-config", "entry": "new_entry", "chips": 1,
         "traffic": {"x": 1}, "limits": {}}))
    (root / "entries" / "new_entry.py").write_text(
        "from benchmark.entries.base import Entry as Base\n\n"
        "class Entry(Base):\n    rate_metric = 'new_rate'\n")
    (root / "metrics" / "new_metric.cell.py").write_text("def read(ctx):\n    return 42.0\n")
    after = {p.relative_to(root) for p in root.rglob("*") if p.is_file()}
    assert before < after  # files were only added
    for p in before:
        assert (root / p).read_bytes() == (BENCH / p).read_bytes()

    cell = harness.load_cell("new-cell", root)
    assert cell["config"] == {"n_vals": 3} and cell["traffic"] == {"x": 1}
    assert harness.load_entry(cell, root).rate_metric == "new_rate"
    spec = dict(SPEC, per_layer=SPEC["per_layer"] + [
        {"name": "new_metric.cell", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "new layer", "moves": "new_rate", "workloads": ["new-cell"]}])
    picked = harness.per_layer_of("new-cell", {"new_rate", "setup_s"}, spec)
    assert [m["name"] for m in picked] == ["new_metric.cell"]
    assert harness.load_metric("new_metric.cell", root)(None) == 42.0


def test_a_metric_without_workloads_follows_its_end_to_end_metric():
    spec = {"per_layer": [{"name": "a", "moves": "td_steps_per_s"},
                          {"name": "b", "moves": "ppo_steps_per_s", "workloads": ["x"]}]}
    assert [m["name"] for m in harness.per_layer_of("y", {"td_steps_per_s"}, spec)] == ["a"]
    assert [m["name"] for m in harness.per_layer_of("x", {"setup_s"}, spec)] == ["b"]
