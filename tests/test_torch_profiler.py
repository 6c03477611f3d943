"""The port's profiling hooks (gym2048_tpu_torch.utils.profiler), the
counterpart of gym2048_tpu.utils.profiler, on the CPU: ``trace`` writes a
Chrome trace file that names the annotated region and the work inside it;
``StepsPerSecond`` is JAX's meter."""

import json
import time

import torch

from gym2048_tpu.utils import profiler as jprofiler
from gym2048_tpu_torch.train import td
from gym2048_tpu_torch.utils import profiler


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    tr = td.TDTrainer(td.TDConfig(n_envs=16, chunk_steps=2, init_value=100.0), "cpu")
    state = tr.init_state()
    with profiler.trace(tmp_path / "traces") as prof:
        with profiler.annotate("td_chunk"):
            state, _ = tr.train_chunk(state, 0.1)
    assert prof.trace_path is not None and prof.trace_path.parent == tmp_path / "traces"
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "td_chunk" in names
    assert any(n and n.startswith("aten::") for n in names)
    assert "td_chunk" in {e.key for e in prof.key_averages()}


def test_trace_default_directory_is_under_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiler.trace() as prof:
        torch.ones(4).sum()
    assert prof.trace_path.parent == tmp_path / "torch-trace"


def test_steps_per_second_is_jax_meter():
    for meter in (profiler.StepsPerSecond(), jprofiler.StepsPerSecond()):
        meter.update(1000)
        time.sleep(0.01)
        assert 0 < meter.rate() < 1000 / 0.01
        meter.mark()
        meter.update(500)
        time.sleep(0.01)
        assert 0 < meter.window_rate() <= 500 / 0.01
        assert meter.total == 1500
