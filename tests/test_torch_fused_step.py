"""The port's fused step module (gym2048_tpu_torch.core.fused_step).

On the CPU each wrapper runs its plain version. These tests hold that
version against the Pallas kernels of gym2048_tpu.core.pallas_step run in
interpret mode, and against the JAX rules, on the same numpy inputs with
tolerance 0 (all outputs are integers or f32 sums of integers below 2**24).
The CUDA kernels themselves are held against these plain versions on the
GPU by chip_smoke.py.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.core import pallas_step, rules as jrules
from gym2048_tpu_torch import _build, interop
from gym2048_tpu_torch.core import fused_step as fs

PHILOX_KAT = [  # Random123 known answers: counter, key, result
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def random_boards(n, seed, max_exp=14, p_zero=0.35):
    rng = np.random.default_rng(seed)
    exps = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def assert_outputs_equal(port, ref):
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype, (i, p.dtype, r.dtype)
        np.testing.assert_array_equal(p.numpy(), r, err_msg=f"output {i}")


def test_cell_major_layout_matches_jax():
    boards = random_boards(64, 0)
    cm = interop.cell_major_from_numpy(boards, device="cpu")
    np.testing.assert_array_equal(
        cm.numpy(), np.asarray(pallas_step.to_cell_major(jnp.asarray(boards))))
    assert cm.is_contiguous()
    np.testing.assert_array_equal(fs.from_cell_major(cm).numpy(), boards)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_move_matches_pallas_and_rules(seed):
    n = 512
    boards = random_boards(n, seed, max_exp=17)
    actions = np.random.default_rng(seed).integers(0, 4, n).astype(np.int32)
    cm = interop.cell_major_from_numpy(boards, device="cpu")
    port = fs.fused_move(cm, torch.as_tensor(actions), 512)
    ref = pallas_step.fused_move(pallas_step.to_cell_major(jnp.asarray(boards)),
                                 jnp.asarray(actions), 512, True)
    assert_outputs_equal(port, ref)
    moved, score, legal = jax.vmap(jrules.apply_action)(jnp.asarray(boards),
                                                        jnp.asarray(actions))
    np.testing.assert_array_equal(fs.from_cell_major(port[0]).numpy(), moved)
    np.testing.assert_array_equal(port[1].numpy(), score)
    np.testing.assert_array_equal(port[2].numpy().astype(bool), legal)


@pytest.mark.parametrize("max_tile_exp", [0, 11])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_step_uniform_matches_pallas(seed, max_tile_exp):
    n = 256
    rng = np.random.default_rng(seed)
    boards = random_boards(n, seed, max_exp=11, p_zero=0.5)
    boards[:8] = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]] * 2, np.int8)  # dead
    u = rng.random((8, n)).astype(np.float32)
    cm = interop.cell_major_from_numpy(boards, device="cpu")
    port = fs.fused_step_uniform(cm, torch.as_tensor(u), 256, max_tile_exp)
    ref = pallas_step.fused_step_uniform(
        pallas_step.to_cell_major(jnp.asarray(boards)), jnp.asarray(u), 256,
        max_tile_exp, True)
    assert_outputs_equal(port, ref)
    finished = port[2].numpy().astype(bool)
    assert finished[:8].all() and (port[3].numpy()[:8] == 0).all()
    if max_tile_exp:  # the won branch ran: live boards finished by a tile of 2**11
        won = finished & (np.asarray(jax.vmap(jrules.is_dead)(jnp.asarray(boards))) == 0)
        assert won.sum() > 10


def test_rollout_equals_steps_on_its_own_uniforms():
    """The plain rollout is T plain steps fed the Philox rows that
    random_uniform_rows gives for each board and step."""
    n, steps, seed = 256, 40, 0xDEADBEEF
    boards = random_boards(n, 3, max_exp=5, p_zero=0.6)
    cm = interop.cell_major_from_numpy(boards, device="cpu")
    want = fs.fused_rollout(cm, seed, steps, 128, max_tile_exp=6)
    u_all = fs.random_uniform_rows(seed, (8 * steps, n), "cpu")
    board, score = cm, torch.zeros(n)
    total, episodes = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
    for t in range(steps):
        u = u_all[8 * t:8 * t + 8]
        _, _, _, total, _ = fs._step_cm(board, score, episodes, total, u, 6)
        board, s, fin, _ = fs.fused_step_uniform(board, u, 128, 6)
        score = torch.where(fin == 1, 0.0, score + s)
        episodes = episodes + fin
    for got, ref in zip((board, score, episodes, total), want):
        assert torch.equal(got, ref)
    assert episodes.sum() > 0


def test_philox_known_answers():
    counter = torch.tensor([k[0] for k in PHILOX_KAT], dtype=torch.int64)
    key = torch.tensor([k[1] for k in PHILOX_KAT], dtype=torch.int64)
    assert fs.philox4x32(counter, key).tolist() == [list(k[2]) for k in PHILOX_KAT]


def test_random_uniform_rows_layout_and_range():
    u = fs.random_uniform_rows(7, (19, 33), "cpu")
    assert u.shape == (19, 33) and u.dtype == torch.float32
    assert (u >= 0).all() and (u < 1).all()
    # rows 8..15 are step 1's uniforms: word r % 4 of counter (c, 1, (r % 8) // 4, 0)
    counter = torch.tensor([[5, 1, 1, 0]], dtype=torch.int64)
    words = fs.philox4x32(counter, torch.tensor([[7, 0]], dtype=torch.int64))[0]
    np.testing.assert_array_equal(u[12:16, 5].numpy(),
                                  ((words >> 8).float() * 2.0**-24).numpy())


def test_rollout_statistics_match_random_play():
    """Random play from empty boards (tests/test_pallas.py::TestRolloutKernel
    bounds): games last ~123 moves and score ~9.1 per step."""
    B, T = 2048, 600
    cm = torch.zeros((16, B), dtype=torch.int32)
    board, _, episodes, total = fs.fused_rollout(cm, 11, T, 1024)
    ep_len = T * B / max(episodes.sum().item(), 1)
    assert 100 < ep_len < 150
    assert 8.0 < total.mean().item() / T < 10.5
    assert torch.unique(board.T, dim=0).shape[0] > 0.9 * B


def test_wrappers_reject_bad_inputs():
    cm = torch.zeros((16, 256), dtype=torch.int32)
    act = torch.zeros(256, dtype=torch.int32)
    u = torch.zeros((8, 256), dtype=torch.float32)
    with pytest.raises(ValueError):
        fs.fused_move(cm.to(torch.int8), act)
    with pytest.raises(ValueError):
        fs.fused_move(cm, act.to(torch.int64))
    with pytest.raises(ValueError):
        fs.fused_move(cm.T.contiguous().T, act)  # not contiguous
    with pytest.raises(ValueError):
        fs.fused_step_uniform(cm, u[:5])
    with pytest.raises(ValueError):
        fs.fused_step_uniform(cm, u, block=96)  # 256 % 96 != 0
    with pytest.raises(ValueError):
        fs.fused_rollout(cm, 0, 4, block=64)  # block not a multiple of 128
    with pytest.raises(ValueError):
        fs.random_uniform_rows(0, (0, 4), "cpu")


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is not a fallback ("meta" stands in for a device)."""
    cm = torch.zeros((16, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fs.fused_move(cm, torch.zeros(128, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fs.fused_rollout(cm, 0, 1, 128)
    with pytest.raises(ValueError, match="no kernel"):
        fs.random_uniform_rows(0, (8, 8), "meta")
    assert all(v == 0 for v in fs.LAUNCHES.values())


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("an nvcc is installed at the default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(library=tmp_path / "lib.so")


def test_build_reruns_only_when_the_source_changes(tmp_path):
    """A stand-in nvcc records its calls: the second build of the same
    source is skipped, an edited source is rebuilt, a failure raises."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> "%s"\n'
                    'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n' % log)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    src, lib = tmp_path / "k.cu", tmp_path / "build" / "lib.so"
    src.write_text("// v1\n")
    assert _build.build(src, lib, str(nvcc)) == lib and lib.read_text() == "lib\n"
    _build.build(src, lib, str(nvcc))
    assert len(log.read_text().splitlines()) == 1
    assert "arch=compute_90a,code=sm_90a" in log.read_text()
    src.write_text("// v2\n")
    _build.build(src, lib, str(nvcc))
    assert len(log.read_text().splitlines()) == 2
    src.write_text("// v3\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(src, lib, "/bin/false")
