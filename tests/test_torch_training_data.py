"""The port's TrainingData (gym2048_tpu_torch.data, a copy) against the JAX
package's (gym2048_tpu.data) on the same transitions: every public method
gives equal arrays, and the CSV files are byte-identical, from the native
writers and from the numpy ones; each package reads the other's files.

Everything is integer or the same float64 numpy arithmetic in the same
order: exact.
"""

import importlib
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

import gym2048_tpu.native as jnative
from gym2048_tpu import data as jdata
from gym2048_tpu_torch import data as tdata
from gym2048_tpu_torch import native

# the packages' ``data.training_data`` is the class alias; the modules by name
jtd = importlib.import_module("gym2048_tpu.data.training_data")
ttd = importlib.import_module("gym2048_tpu_torch.data.training_data")

FIELDS = ("get_x", "get_y_digit", "get_reward", "get_next_x", "get_done")


def transitions(n, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 12, size=(n, 4, 4))
    boards = np.where(e > 0, np.left_shift(1, e), 0)
    boards[1] = boards[0]  # a duplicate board for make_boards_unique
    nexts = np.roll(boards, 1, axis=2)
    return (boards, rng.integers(0, 4, n), rng.integers(0, 5000, n) / 4.0, nexts,
            rng.random(n) < 0.1)


def pair(n=40, seed=0):
    """The same transitions added to a JAX and a port TrainingData."""
    out = []
    for cls in (jdata.TrainingData, tdata.TrainingData):
        td = cls()
        for row in zip(*transitions(n, seed)):
            td.add(*row)
        out.append(td)
    return out


def assert_same(j, t):
    assert j.size() == t.size()
    for get in FIELDS:
        want, got = getattr(j, get)(), getattr(t, get)()
        assert got.dtype == want.dtype and got.shape == want.shape, get
        np.testing.assert_array_equal(got, want, err_msg=get)


def test_alias_stack_and_getters():
    assert tdata.training_data is tdata.TrainingData
    j, t = pair()
    assert_same(j, t)
    for get in ("get_x_stacked", "get_y_one_hot", "get_x_exponents"):
        np.testing.assert_array_equal(getattr(t, get)(), getattr(j, get)())
    assert t.get_total_reward() == j.get_total_reward()
    assert t.get_highest_tile() == j.get_highest_tile()
    np.testing.assert_array_equal(t.get_discounted_return(0.9), j.get_discounted_return(0.9))
    for n in (0, 7, 39):
        for got, want in zip(t.get_n(n), j.get_n(n)):
            np.testing.assert_array_equal(got, want)
    assert t.construct_header() == j.construct_header()
    assert t.construct_header(True) == j.construct_header(True)
    np.testing.assert_array_equal(ttd.stack(j.get_x(), 12), jtd.stack(j.get_x(), 12))
    out_j, out_t = io.StringIO(), io.StringIO()
    with redirect_stdout(out_j):
        j.dump()
    with redirect_stdout(out_t):
        t.dump()
    assert out_t.getvalue() == out_j.getvalue()


OPS = {
    "log2_rewards": lambda td: td.log2_rewards(),
    "normalize_boards": lambda td: td.normalize_boards(),
    "normalize_boards_given": lambda td: td.normalize_boards(3.0, 2.0),
    "normalize_rewards": lambda td: td.normalize_rewards(),
    "hflip": lambda td: td.hflip(),
    "rotate_1": lambda td: td.rotate(1),
    "rotate_3": lambda td: td.rotate(3),
    "augment": lambda td: td.augment(),
    "make_boards_unique": lambda td: td.make_boards_unique(),
    "shuffle": lambda td: (np.random.seed(11), td.shuffle()),
    "merge_self_copy": lambda td: td.merge(td.copy()),
    "update": lambda td: td._update(np.arange(td.size())[::-3]),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_each_transform_matches_jax(op):
    j, t = pair()
    OPS[op](j)
    OPS[op](t)
    assert_same(j, t)


def test_split_sample_merge_copy_from_rollout():
    j, t = pair()
    for a, b in zip(j.split(0.3), t.split(0.3)):
        assert_same(a, b)
    assert_same(j.sample([5, 1, 1, 30]), t.sample([5, 1, 1, 30]))
    jc, tc = j.copy(), t.copy()
    jc.merge(j.sample([0, 2]))
    tc.merge(t.sample([0, 2]))
    assert_same(jc, tc)
    assert t.size() == 40  # the copy is independent
    rng = np.random.default_rng(4)
    args = (rng.integers(0, 12, (9, 4, 4)).astype(np.int8), rng.integers(0, 4, 9),
            rng.integers(0, 500, 9).astype(np.float32), rng.integers(0, 12, (9, 4, 4)),
            rng.random(9) < 0.3)
    assert_same(jdata.TrainingData.from_rollout(*args), tdata.TrainingData.from_rollout(*args))


@pytest.mark.parametrize("add_returns", [False, True])
@pytest.mark.parametrize("mode", ["native", "numpy"])
def test_csv_byte_identical_and_read_across(tmp_path, mode, add_returns):
    if mode == "native" and not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")
    j, t = pair(60, 1)
    saved = jnative._lib, jnative._build_error
    try:
        if mode == "numpy":
            jnative._lib, jnative._build_error = None, "forced"
            with native.unavailable():
                t.export_csv(tmp_path / "port.csv", add_returns=add_returns)
        else:
            t.export_csv(tmp_path / "port.csv", add_returns=add_returns)
        j.export_csv(tmp_path / "jax.csv", add_returns=add_returns)
    finally:
        jnative._lib, jnative._build_error = saved
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    # each package reads the other's file
    jr, tr = jdata.TrainingData(), tdata.TrainingData()
    jr.import_csv(tmp_path / "port.csv")
    tr.import_csv(tmp_path / "jax.csv")
    assert_same(jr, tr)
    np.testing.assert_array_equal(tr.get_x(), t.get_x())
    np.testing.assert_array_equal(tr.get_reward(), t.get_reward())
