"""The port's checkpoints and loaders (gym2048_tpu_torch.utils.checkpoint):
the bf16 artifact decodes bit for bit as JAX's ``load_array_bf16`` decodes
it (which uses ml_dtypes; the port does not), a ``save_model`` pickle loads
back, and the ``Checkpointer`` (the JAX layout ``<root>/<step>/``, without
Orbax) saves, prunes and restores a whole PPO train state exactly."""

import numpy as np
import pytest
import torch

from gym2048_tpu.utils import checkpoint as jck
from gym2048_tpu_torch.utils import checkpoint as tck


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contend with each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("delta_stages", [1, 3])
def test_load_array_bf16_matches_jax(tmp_path, delta_stages):
    rng = np.random.default_rng(delta_stages)
    stage = (rng.normal(size=3000) * 1e3).astype(np.float32)
    a = np.concatenate([stage] * delta_stages)
    a[:: 7] += 1.0  # later stages differ from stage 0 in some entries
    a[:4] = [0.0, -0.0, np.inf, 1e-40]  # zero, signed zero, inf, a denormal
    prefix = tmp_path / "table"
    jck.save_array_bf16(prefix, a, meta={"arch": "4x6"}, part_bytes=1000,
                        delta_stages=delta_stages)
    want, want_meta = jck.load_array_bf16(prefix)
    got, meta = tck.load_array_bf16(prefix)
    assert got.dtype == np.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert meta == want_meta == {"arch": "4x6"}


def test_load_array_bf16_rejects_a_foreign_format(tmp_path):
    prefix = tmp_path / "x"
    jck.save_array_bf16(prefix, np.zeros(4, np.float32))
    header = prefix.with_name("x.meta.json")
    header.write_text(header.read_text().replace("bf16_zlib_v1", "other"))
    with pytest.raises(ValueError, match="format"):
        tck.load_array_bf16(prefix)


def test_load_model_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    variables = {"table": rng.normal(size=100).astype(np.float32),
                 "nested": {"w": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    meta = {"config": {"arch": "4x6", "n_vals": 16, "thresholds": [12, 13]}}
    path = tmp_path / "m.pkl"
    jck.save_model(path, variables, meta)
    got, got_meta = tck.load_model(path)
    np.testing.assert_array_equal(got["table"], variables["table"])
    np.testing.assert_array_equal(got["nested"]["w"], variables["nested"]["w"])
    assert got_meta == meta
    jck.save_model(path, variables)
    assert tck.load_model(path)[1] == {}


# ------------------------------------------------------------- Checkpointer

def test_checkpointer_layout_latest_step_and_pruning(tmp_path):
    ck = tck.Checkpointer(tmp_path / "ck", keep=2)
    assert ck.latest_step() is None and ck.all_steps() == []
    with pytest.raises(FileNotFoundError):
        ck.restore()
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "a": np.arange(4, dtype=np.int16), "n": 3, "nested": [torch.ones(2), 0.5]}
    for step in (1, 5, 3):
        path = ck.save(step, tree)
        assert path == ck.root / str(step) and (path / "state.pt").is_file()
    assert ck.all_steps() == [3, 5] and ck.latest_step() == 5  # 1 pruned (keep=2)
    assert sorted(p.name for p in ck.root.iterdir()) == ["3", "5"]  # no temporary left
    raw = ck.restore()
    assert raw["n"] == 3 and torch.equal(raw["w"], tree["w"])
    assert torch.equal(raw["a"], torch.arange(4, dtype=torch.int16))
    like = {"w": torch.zeros(2, 3, dtype=torch.float64), "a": np.zeros(4, np.int16), "n": 0,
            "nested": [torch.zeros(2), 0.0]}
    back = ck.restore(3, like=like)
    assert back["w"].dtype == torch.float64 and torch.equal(back["w"], tree["w"].double())
    assert isinstance(back["a"], np.ndarray) and np.array_equal(back["a"], tree["a"])
    assert back["n"] == 3 and back["nested"][1] == 0.5
    with pytest.raises(ValueError, match="keys"):
        ck.restore(like={"w": torch.zeros(2, 3)})
    ck.save(5, {"x": torch.zeros(1)})  # a step saved again replaces the old one
    assert set(ck.restore(5)) == {"x"}


def small_ppo():
    from gym2048_tpu_torch.train import ppo

    cfg = ppo.PPOConfig(total_timesteps=10**6, n_envs=8, n_steps=4, batch_size=16, n_epochs=1,
                        filters=4, residual_blocks=1, seed=3)
    return ppo.PPO(cfg, device="cpu")


def test_train_state_round_trip(tmp_path):
    """A PPO ``TrainState`` after an iteration, restored into a fresh state
    from another seed: every leaf equal (weights, BatchNorm statistics,
    Adam's moments and step, the schedule's count, the envs, the
    generator's state, ``update_idx``), and the next iteration identical."""
    tr = small_ppo()
    state, _ = tr.train_iteration(tr.init_state())
    ck = tck.Checkpointer(tmp_path)
    ck.save(1, state)
    fresh = tr.init_state(torch.Generator().manual_seed(99))
    restored = ck.restore(1, like=fresh)
    assert restored.model is fresh.model and restored.generator is fresh.generator
    assert restored.update_idx == 1 and restored.optimizer.count == state.optimizer.count
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    adam, adam2 = state.optimizer.adam.state_dict(), restored.optimizer.adam.state_dict()
    assert adam["param_groups"] == adam2["param_groups"]
    for i, s in adam["state"].items():
        for k, v in s.items():
            assert torch.equal(v, adam2["state"][i][k]), (i, k)
    for f in ("board", "score", "done", "step_count"):
        assert torch.equal(getattr(state.env_state, f), getattr(restored.env_state, f))
    assert torch.equal(state.generator.get_state(), restored.generator.get_state())
    a, _ = tr.train_iteration(state)
    b, _ = tr.train_iteration(restored)
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)


def test_generator_state_from_another_device_type_seeds_deterministically():
    """A generator's stream cannot cross device types (Mersenne Twister on
    the CPU, Philox on CUDA): a CUDA generator's saved state seeds a CPU
    generator from its digest, the same way every time."""
    saved = {"generator_state": torch.arange(16, dtype=torch.uint8), "device_type": "cuda"}
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        assert tck._restore_into(g, saved) is g
        draws.append(torch.rand(4, generator=g))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], torch.rand(4, generator=torch.Generator().manual_seed(0)))
