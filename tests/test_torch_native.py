"""The port's native engine and CSV codec (gym2048_tpu_torch.native) against
the JAX package's (gym2048_tpu.native) and the port's numpy paths.

The port builds its own copy of ``engine2048.cpp`` with ``g++`` into
``build/`` (or a path the caller gives), never beside either package's
source. Everything compared is integers, or CSV bytes: exact.
"""

import numpy as np
import pytest

from gym2048_tpu import native as jnative
from gym2048_tpu_torch import native
from gym2048_tpu_torch.data import TrainingData



@pytest.fixture(autouse=True)
def toolchain():
    """Build (or load) the library inside the test, not at import: every
    test worker imports this file."""
    if not native.available():
        pytest.skip(f"no C++ toolchain: {native._build_error}")

ROOT = native.SOURCE.parents[2]


def listing(directory):
    return {p.name: p.stat().st_mtime_ns for p in directory.iterdir()}


def exp_boards(n, seed, max_exp=17, p_zero=0.3):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, e).astype(np.int8)


def test_builds_under_build_and_nowhere_else(tmp_path):
    assert native.LIBRARY.parent == ROOT / "build"
    assert native.SOURCE.read_bytes() == (ROOT / "gym2048_tpu/native/engine2048.cpp").read_bytes()
    beside = [native.SOURCE.parent, ROOT / "gym2048_tpu" / "native"]
    before = [listing(d) for d in beside]
    lib = native.build(library=tmp_path / "out" / "libengine.so")
    assert lib.is_file() and lib.with_suffix(".sha256").is_file()
    assert sorted(p.name for p in lib.parent.iterdir()) == ["libengine.sha256", "libengine.so"]
    stamp = lib.stat().st_mtime_ns
    assert native.build(library=lib) == lib and lib.stat().st_mtime_ns == stamp  # up to date
    assert [listing(d) for d in beside] == before
    assert "-march=native" not in native.GXX_FLAGS
    assert native.get_lib()._name == str(native.LIBRARY)


def test_shift_row_golden():
    cases = [([1, 1, 1, 3], [2, 1, 3, 0], 4), ([2, 2, 2, 2], [3, 3, 0, 0], 16),
             ([0, 1, 0, 2], [1, 2, 0, 0], 0), ([15, 15, 0, 0], [16, 0, 0, 0], 65536)]
    for row, expected, score in cases:
        out, s = native.shift_row(np.asarray(row, np.int8))
        assert out.tolist() == expected and s == score
        assert (out.tolist(), s) == (jnative.shift_row(np.asarray(row, np.int8))[0].tolist(),
                                     jnative.shift_row(np.asarray(row, np.int8))[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_move_batch_matches_jax(seed):
    boards = exp_boards(4096, seed)
    actions = np.random.default_rng(seed + 10).integers(0, 4, len(boards)).astype(np.int32)
    got = native.move_batch(boards, actions)
    want = jnative.move_batch(boards, actions)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2].any() and not got[2].all()


def sample_td(n, seed):
    rng = np.random.default_rng(seed)
    td = TrainingData()
    for _ in range(n):
        e = rng.integers(0, 12, size=(4, 4))
        board = np.where(e > 0, 1 << e, 0)
        td.add(board, int(rng.integers(0, 4)), float(rng.integers(0, 4000)) / 8, board.T,
               bool(rng.random() < 0.1))
    return td


@pytest.mark.parametrize("add_returns", [False, True])
def test_native_write_matches_numpy_write(tmp_path, add_returns):
    td = sample_td(200, 0)
    td.export_csv(tmp_path / "native.csv", add_returns=add_returns)
    with native.unavailable():
        assert not native.available()
        td.export_csv(tmp_path / "numpy.csv", add_returns=add_returns)
    assert native.available()
    assert (tmp_path / "native.csv").read_bytes() == (tmp_path / "numpy.csv").read_bytes()


def test_native_read_matches_numpy_read(tmp_path):
    path = tmp_path / "d.csv"
    sample_td(150, 1).export_csv(path, add_returns=True)
    parsed = native.csv_read(path)
    a = TrainingData()
    a.import_csv(path)
    with native.unavailable():
        assert native.csv_read(path) is None
        b = TrainingData()
        b.import_csv(path)
    for get in ("get_x", "get_y_digit", "get_reward", "get_next_x", "get_done"):
        got, want = getattr(a, get)(), getattr(b, get)()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(parsed[0], a.get_x())
    with pytest.raises(FileNotFoundError):
        native.csv_read(tmp_path / "missing.csv")
