"""The port's table lookup (gym2048_tpu_torch.models.table_gather).

On the CPU ``gather_values`` runs its plain version (``torch.take``). It is
held here against the Pallas kernel of gym2048_tpu.models.pallas_table in
interpret mode on the same numpy inputs, with tolerance 0: a lookup copies.
The CUDA kernel itself is held against the plain version on the GPU by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.models import pallas_table
from gym2048_tpu_torch.models import table_gather as tg


def both(table: np.ndarray, idx: np.ndarray, chunk: int, n_sem: int):
    want = np.asarray(pallas_table.gather_values(
        jnp.asarray(table), jnp.asarray(idx), chunk=chunk, n_sem=n_sem, interpret=True))
    got = tg.gather_values(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    return got, want


def test_random_indices_match_pallas():
    rng = np.random.default_rng(0)
    table = rng.normal(size=128 * 257).astype(np.float32)
    idx = rng.integers(0, table.shape[0], size=1024).astype(np.int32)
    got, want = both(table, idx, 256, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])


def test_duplicate_and_boundary_indices_match_pallas():
    table = np.arange(128 * 16, dtype=np.float32)
    idx = np.asarray([0, 127, 128, 128 * 16 - 1, 5, 5, 5, 0] * 32, np.int32)
    got, want = both(table, idx, 128, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, s", [(1, 1), (7, 1000), (1001, 129), (4099, 65537)])
def test_any_n_and_table_size(n, s):
    """No N % chunk or S % 128 rule in the port."""
    rng = np.random.default_rng(n)
    table = rng.normal(size=s).astype(np.float32)
    idx = rng.integers(0, s, size=n).astype(np.int32)
    idx[0] = s - 1
    got = tg.gather_values(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), table[idx])
    # the plain version itself, as chip_smoke.py uses it on the card
    np.testing.assert_array_equal(
        tg.gather_values_reference(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
        table[idx])


def test_empty_index_vector():
    got = tg.gather_values(torch.zeros(8), torch.zeros(0, dtype=torch.int32))
    assert got.shape == (0,) and got.dtype == torch.float32


@pytest.mark.parametrize("table, idx", [
    (torch.zeros(16, dtype=torch.float64), torch.zeros(4, dtype=torch.int32)),
    (torch.zeros(16), torch.zeros(4, dtype=torch.int64)),
    (torch.zeros(16), torch.zeros((2, 2), dtype=torch.int32)),
    (torch.zeros((4, 4)), torch.zeros(4, dtype=torch.int32)),
    (torch.zeros(32)[::2], torch.zeros(4, dtype=torch.int32)),
])
def test_wrapper_rejects_bad_inputs(table, idx):
    with pytest.raises(ValueError):
        tg.gather_values(table, idx)


def test_out_of_range_index_raises_on_the_cpu():
    with pytest.raises((IndexError, RuntimeError)):
        tg.gather_values(torch.zeros(16), torch.tensor([16], dtype=torch.int32))


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is not a fallback ("meta" stands in for a device)."""
    table = torch.zeros(256, device="meta")
    idx = torch.zeros(64, dtype=torch.int32, device="meta")
    before = dict(tg.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel"):
        tg.gather_values(table, idx)
    assert tg.LAUNCHES == before


def test_build_all_starts_one_nvcc_per_source(tmp_path, monkeypatch):
    """A stand-in nvcc marks its start and waits up to 10 s for a second
    one: "together" in its log shows that both compilers ran at once. Each
    source gets its own library and stamp; a second call builds nothing."""
    import stat

    from gym2048_tpu_torch import _build

    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        '#!/bin/sh\ntouch "%s/started.$$"; i=0\n'
        'while [ $(ls "%s" | grep -c started) -lt 2 ] && [ $i -lt 200 ]; do\n'
        '  sleep 0.05; i=$((i+1)); done\n'
        'if [ $i -lt 200 ]; then echo together >> "%s"; else echo alone >> "%s"; fi\n'
        'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
        % (tmp_path, tmp_path, log, log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    libs = {}
    for name in ("one", "two"):
        (tmp_path / f"{name}.cu").write_text(f"// {name}\n")
        libs[name] = (tmp_path / f"{name}.cu", tmp_path / "build" / f"lib{name}.so")
    monkeypatch.setattr(_build, "LIBRARIES", libs)
    paths = _build.build_all(str(nvcc))
    assert paths == {name: lib for name, (_, lib) in libs.items()}
    assert all(p.read_text() == "lib\n" and p.with_suffix(".sha256").is_file()
               for p in paths.values())
    assert log.read_text().splitlines() == ["together", "together"]
    _build.build_all(str(nvcc))
    assert len(log.read_text().splitlines()) == 2
    (tmp_path / "two.cu").write_text("// two, edited\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all("/bin/false")
    assert paths["one"].read_text() == "lib\n"


def test_libraries_name_every_source():
    from gym2048_tpu_torch import _build

    sources = {src.name for src, _ in _build.LIBRARIES.values()}
    assert sources == {p.name for p in _build.CSRC.glob("*.cu")}
    assert len({lib for _, lib in _build.LIBRARIES.values()}) == len(_build.LIBRARIES)
    assert set(_build._SIGNATURES) == set(_build.LIBRARIES)
