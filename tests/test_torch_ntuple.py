"""The port's small 17 x 4-cell n-tuple network (gym2048_tpu_torch.models.ntuple)
against gym2048_tpu.models.ntuple on the same numpy inputs.

Tolerances, with their reasons:

* Tuples, cells and feature indices are integers: equal integer for integer.
* Values are f32 sums of 136 entries over 8. On tables of small integers
  every partial sum is exact, so they are equal bit for bit. On the
  committed trained table (``docs/curves/ntuple_table_tc1b.pkl``) XLA's CPU
  backend adds the 136 in order and torch does not; each order is off the
  exact sum by at most 135 unit roundoffs (2**-24) of the sum of the
  magnitudes, so the two values are held to 2 x 136 x 2**-24 x
  sum |entry| / 8.
* ``split_table``: ``hi`` is the bf16 rounding of each entry on both sides,
  bit for bit. JAX's CPU ``lo`` stays f32 (``_mxu_dtype``); the port's is
  ``bf16(t - hi)``, as on the TPU: equal to JAX's ``lo`` rounded to bf16,
  bit for bit, so within one bf16 rounding (2**-8 relative) of it.
* ``value_batch_mxu`` with ``t_lo=None`` reads the same ``hi`` entries:
  the summation tolerance above. With ``t_lo`` the port's entries are off
  JAX's by at most 2**-16 of their magnitude: 2**-16 x sum |entry| / 8
  more.
* TD and TC updates on small-integer tables with dyadic TD errors are
  exact in any order: bit for bit, with the JAX side run op by op
  (``jax.disable_jit``; compiled, XLA's CPU backend fuses the TC combine's
  last multiply-add, ROADMAP.md Queue 3).
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.models import ntuple as jnt
from gym2048_tpu_torch.models import ntuple as tnt

TC1B = Path(__file__).resolve().parent.parent / "docs" / "curves" / "ntuple_table_tc1b.pkl"
U = 2.0 ** -24  # f32 unit roundoff


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contending with each other
    ran a training test here 30 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def boards(n, seed, max_exp=17, p_zero=0.3):
    """Random exponent boards, 16 and 17 included (both clip to 16)."""
    rng = np.random.default_rng(seed)
    exps = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def assert_bits(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def int_table(seed, n_stages=1, lo=-64, hi=64):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, n_stages * jnt.STAGE_STRIDE).astype(np.float32)


def trained_table():
    with open(TC1B, "rb") as f:
        return np.asarray(pickle.load(f)["variables"]["table"], np.float32)


def staged(table, n_stages):
    """A staged table whose stages differ: stage s is the table times 1 + s/4."""
    return np.concatenate([table * np.float32(1 + s / 4) for s in range(n_stages)])


def magnitudes(table, b, thresholds=()):
    """sum |entry| / 8 over each board's 136 looked-up entries."""
    idx = np.asarray(jax.vmap(jnt.feature_indices)(jnp.asarray(b)))
    if thresholds:
        st = np.asarray(jnt.stage_of_batch(jnp.asarray(b), thresholds))
        idx = idx + st[:, None] * jnt.STAGE_STRIDE
    return np.abs(table[idx]).astype(np.float64).sum(-1) / 8.0


def test_constants_match_jax():
    np.testing.assert_array_equal(tnt.TUPLES, jnt.TUPLES)
    np.testing.assert_array_equal(tnt.SYMS, jnt.SYMS)
    np.testing.assert_array_equal(tnt.CELLS, jnt.CELLS)
    np.testing.assert_array_equal(tnt._POW, jnt._POW)
    np.testing.assert_array_equal(tnt._OFFSET, jnt._OFFSET)
    assert (tnt.N_VALS, tnt.TUPLE_LEN, tnt.TABLE_SIZE, tnt.N_TUPLES, tnt.STAGE_STRIDE,
            tnt.N_FEATURES) == (jnt.N_VALS, jnt.TUPLE_LEN, jnt.TABLE_SIZE, jnt.N_TUPLES,
                                jnt.STAGE_STRIDE, jnt.N_FEATURES)
    net = tnt.network()
    assert net.stage_stride == tnt.STAGE_STRIDE and net.n_features == tnt.N_FEATURES
    assert tnt.network((3, 5)).table_size == 3 * tnt.STAGE_STRIDE


def test_indices_match_jax():
    b = boards(300, 0)
    assert (b >= 16).any() and (b == 17).any()
    want_local = np.asarray(jnt.local_indices_batch(jnp.asarray(b)))
    got_local = tnt.local_indices_batch(t(b))
    assert_bits(got_local, want_local)
    assert_bits(got_local, np.asarray(jax.vmap(jnt.local_indices)(jnp.asarray(b))))
    for i in (0, 7, 299):
        assert_bits(tnt.local_indices(t(b[i])), np.asarray(jnt.local_indices(jnp.asarray(b[i]))))
        assert_bits(tnt.feature_indices(t(b[i])),
                    np.asarray(jnt.feature_indices(jnp.asarray(b[i]))))
    got = tnt.network().indices_batch(t(b))
    assert_bits(got, np.asarray(jax.vmap(jnt.feature_indices)(jnp.asarray(b))))
    assert int(got.max()) < tnt.STAGE_STRIDE and int(got.min()) >= 0


@pytest.mark.parametrize("thresholds", [(), (6, 9)])
def test_values_bit_exact_on_integer_tables(thresholds):
    n_stages = len(thresholds) + 1
    table = int_table(1, n_stages)
    b = boards(200, 2, max_exp=12)
    want = np.asarray(jnt.value_batch(jnp.asarray(table), jnp.asarray(b), thresholds))
    assert_bits(tnt.value_batch(t(table), t(b), thresholds), want)
    for i in (0, 1, 199):
        assert_bits(tnt.value(t(table), t(b[i]), thresholds),
                    np.asarray(jnt.value(jnp.asarray(table), jnp.asarray(b[i]), thresholds)))


@pytest.mark.parametrize("thresholds", [(), (10, 11)])
def test_values_on_the_committed_table(thresholds):
    table = staged(trained_table(), len(thresholds) + 1)
    b = boards(256, 3, max_exp=13)
    want = np.asarray(jnt.value_batch(jnp.asarray(table), jnp.asarray(b), thresholds))
    got = tnt.value_batch(t(table), t(b), thresholds).numpy()
    tol = 2 * 136 * U * magnitudes(table, b, thresholds)
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()
    assert np.median(np.abs(want)) > 1000.0  # a trained table: values in score units


def unpad(x, n_stages):
    """JAX's (17, S * 653, 128) split layout -> the flat table layout."""
    x = np.asarray(x).reshape(jnt.N_TUPLES, n_stages, jnt._HI * jnt._LANES)
    return x[:, :, :jnt.TABLE_SIZE].transpose(1, 0, 2).reshape(-1)


@pytest.mark.parametrize("n_stages", [1, 2])
def test_split_table_matches_jax(n_stages):
    table = staged(trained_table(), n_stages)
    table[:5] = [0.0, -0.0, 1e-40, 3.0e38, -7.5]  # zeros, a subnormal, a large entry
    jhi, jlo = jnt.split_table(jnp.asarray(table))
    assert jlo.dtype == jnp.float32  # the CPU keeps lo in f32
    hi, lo = tnt.split_table(t(table))
    assert hi.dtype == lo.dtype == torch.float32
    assert_bits(hi, unpad(jhi, n_stages))
    jlo = unpad(jlo, n_stages)
    assert_bits(lo, t(jlo).to(torch.bfloat16).to(torch.float32).numpy())
    assert (np.abs(lo.numpy().astype(np.float64) - jlo) <= 2.0 ** -8 * np.abs(jlo)).all()
    with pytest.raises(ValueError):
        tnt.split_table(torch.zeros(10))


@pytest.mark.parametrize("with_lo", [False, True])
@pytest.mark.parametrize("thresholds", [(), (10, 11)])
def test_value_batch_mxu_matches_jax(with_lo, thresholds):
    n_stages = len(thresholds) + 1
    table = staged(trained_table(), n_stages)
    b = boards(128, 4, max_exp=13)
    jhi, jlo = jnt.split_table(jnp.asarray(table))
    want = np.asarray(jnt.value_batch_mxu(jhi, jlo if with_lo else None, jnp.asarray(b),
                                          chunk=256, thresholds=thresholds))
    hi, lo = tnt.split_table(t(table))
    got = tnt.value_batch_mxu(hi, lo if with_lo else None, t(b), thresholds=thresholds).numpy()
    mag = magnitudes(table, b, thresholds)
    tol = 2 * 136 * U * mag + (2.0 ** -16 * mag if with_lo else 0.0)
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()
    exact = tnt.value_batch(t(table), t(b), thresholds).numpy().astype(np.float64)
    if with_lo:  # the split lookup is the table's value to ~2**-16
        assert (np.abs(got - exact) <= 2 * 136 * U * mag + 2.0 ** -16 * mag).all()
    else:  # the bf16 lookup is not
        assert (got != exact).any()
    with pytest.raises(ValueError, match="stages"):
        tnt.value_batch_mxu(hi, None, t(b), thresholds=thresholds + (12,))


def _updates(seed, n, n_stages=1):
    rng = np.random.default_rng(seed)
    b = boards(n, seed, max_exp=11)
    b[1] = b[0]  # two boards on the same entries: counts > 1
    size = n_stages * jnt.STAGE_STRIDE
    table = rng.integers(-50, 50, size).astype(np.float32)
    tc_e = rng.integers(-8, 8, size).astype(np.float32)
    tc_a = np.abs(tc_e) + rng.integers(0, 4, size).astype(np.float32)
    tc_a[::5] = 0.0
    tc_e[::5] = 0.0  # untouched entries: rate 1 where the step adds none
    d = (rng.integers(-64, 64, n) / 8).astype(np.float32)
    valid = rng.random(n) < 0.7
    return table, tc_e, tc_a, b, d, valid


@pytest.mark.parametrize("n_stages", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["td_update", "td_update_tc"])
def test_td_updates_match_jax_bit_for_bit(fn, masked, n_stages):
    table, tc_e, tc_a, b, d, valid = _updates(5, 24, n_stages)
    v = valid if masked else None
    jargs = [jnp.asarray(x) for x in (table, tc_e, tc_a, b, d)]
    targs = [t(x) for x in (table, tc_e, tc_a, b, d)]
    with jax.disable_jit():
        if fn == "td_update":
            want = (jnt.td_update(jargs[0], *jargs[3:], 0.5,
                                  None if v is None else jnp.asarray(v)),)
        else:
            want = jnt.td_update_tc(*jargs, 0.5, None if v is None else jnp.asarray(v))
    if fn == "td_update":
        got = (tnt.td_update(targs[0], *targs[3:], 0.5, None if v is None else t(v)),)
    else:
        got = tnt.td_update_tc(*targs, 0.5, None if v is None else t(v))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits(g, w, fn)
    assert not torch.equal(got[0], targs[0])  # the table moved
    if n_stages > 1:  # only stage 0 is updated
        assert torch.equal(got[0][tnt.STAGE_STRIDE:], targs[0][tnt.STAGE_STRIDE:])


@pytest.mark.parametrize("tc", [False, True])
def test_one_board_update_moves_its_value_by_alpha_delta(tc):
    """As tests/test_td.py holds JAX to: count normalisation makes a
    one-board update move its value by alpha * delta, duplicate features
    or not (with TC, an entry's first touch has rate 1). Exactly so in real
    arithmetic; in f32 the update 8 / 136 rounds: within 1e-6 relative
    (JAX's test: 1e-5)."""
    table = tnt.init_table(0.0, device="cpu")
    for board in ([[1, 2, 0, 0], [0, 3, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1]],
                  [[1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]):
        board = torch.tensor(board, dtype=torch.int8)
        if tc:
            zero = torch.zeros_like(table)
            t2 = tnt.td_update_tc(table, zero, zero, board[None], torch.tensor([10.0]), 0.5)[0]
        else:
            t2 = tnt.td_update(table, board[None], torch.tensor([10.0]), alpha=0.5)
        assert float(tnt.value(t2, board)) == pytest.approx(5.0, rel=1e-6)


def test_init_and_promote_match_jax():
    assert_bits(tnt.init_table(3.5, 2, device="cpu"), np.asarray(jnt.init_table(3.5, 2)))
    table = int_table(6)
    assert_bits(tnt.promote_table(t(table), 3), np.asarray(jnt.promote_table(
        jnp.asarray(table), 3)))
    assert tnt.n_stages_of(tnt.init_table(0.0, 3, device="cpu")) == 3


@pytest.mark.parametrize("impl", ["auto", "gather", "mxu", "mxu_bf16"])
def test_small_net_modes(impl):
    table = staged(trained_table(), 1)
    b = t(boards(32, 8, max_exp=12))
    net = tnt.SmallNet(impl)
    params = net.params(t(table))
    got = net.value_batch(params, b)
    hi, lo = tnt.split_table(t(table))
    want = {"auto": lambda: tnt.value_batch(t(table), b),
            "gather": lambda: tnt.value_batch(t(table), b),
            "mxu": lambda: tnt.value_batch_mxu(hi, lo, b),
            "mxu_bf16": lambda: tnt.value_batch_mxu(hi, None, b)}[impl]()
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tnt.SmallNet("rows")
