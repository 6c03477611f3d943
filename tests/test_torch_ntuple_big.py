"""The port's n-tuple networks (gym2048_tpu_torch.models.ntuple_big and the
helpers of models.ntuple) against the JAX package on the same numpy inputs.

Feature indices, stages and promoted tables are integers or copies: equal
bit for bit. Values are f32 sums of 8T entries over 8; with tables of small
integers every partial sum is exact, so they are equal bit for bit too. With
normal tables the two frameworks may add in different orders, and a sum's
rounding error scales with the sum of its terms' magnitudes, not with the
sum (which may cancel to near 0): the tolerance is 1e-6 of sum |entry| / 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.models import ntuple as jnt
from gym2048_tpu.models import ntuple_big as jnb
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.models import ntuple as tnt
from gym2048_tpu_torch.models import ntuple_big as tnb

# two 4-cell tuples, staged at exponents 6 and 8: 3 x 131,072 entries
SMALL_TUPLES = ((0, 1, 2, 3), (0, 1, 4, 5))
SMALL_THRESHOLDS = (6, 8)


def boards(n, seed, max_exp=17, p_zero=0.3):
    rng = np.random.default_rng(seed)
    exps = rng.integers(0, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def test_symmetries_match_jax():
    np.testing.assert_array_equal(tnt.SYMS, jnt.SYMS)


@pytest.mark.parametrize("thresholds", [(), (12, 13)])
@pytest.mark.parametrize("arch", ["4x6", "5x6", "4x6_4x4"])
def test_indices_batch_matches_jax(arch, thresholds):
    b = boards(512, seed=len(arch) + len(thresholds))
    jnet = jnb.make_network(arch, 16, thresholds)
    tnet = tnb.make_network(arch, 16, thresholds)
    assert tnet.table_size == jnet.table_size
    assert tnet.stage_stride == jnet.stage_stride
    got = tnet.indices_batch(torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (512, jnet.n_features)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnet.indices_batch(jnp.asarray(b))))


def test_flagship_geometry():
    net = tnb.make_network("4x6", 16, (12, 13))
    assert net.n_features == 32
    assert net.stage_stride == 4 * 16 ** 6 == 67_108_864
    assert net.table_size == 201_326_592


@pytest.mark.parametrize("integer_table", [True, False])
@pytest.mark.parametrize("value_impl", ["gather", "rows"])
def test_value_batch_matches_jax(integer_table, value_impl):
    jnet = jnb.NTupleNetwork(SMALL_TUPLES, 16, SMALL_THRESHOLDS, value_impl=value_impl)
    tnet = tnb.NTupleNetwork(SMALL_TUPLES, 16, SMALL_THRESHOLDS, value_impl=value_impl)
    rng = np.random.default_rng(3)
    if integer_table:
        table = rng.integers(-50, 50, size=jnet.table_size).astype(np.float32)
    else:
        table = (rng.normal(size=jnet.table_size) * 100).astype(np.float32)
    b = boards(256, seed=4, max_exp=10)
    want = np.asarray(jnet.value_batch(jnp.asarray(table), jnp.asarray(b)))
    got = tnet.value_batch(interop.table_from_numpy(table, "cpu"), torch.from_numpy(b))
    assert got.dtype == torch.float32
    fn = tnet.make_value_fn(interop.table_from_numpy(table, "cpu"))
    np.testing.assert_array_equal(fn(torch.from_numpy(b)).numpy(), got.numpy())
    if integer_table:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        idx = np.asarray(jnet.indices_batch(jnp.asarray(b)))
        scale = np.abs(table[idx]).sum(-1) / 8
        assert (np.abs(got.numpy() - want) <= 1e-6 * scale).all()


def test_init_table_matches_jax():
    jnet = jnb.NTupleNetwork(SMALL_TUPLES, 16, SMALL_THRESHOLDS)
    tnet = tnb.NTupleNetwork(SMALL_TUPLES, 16, SMALL_THRESHOLDS)
    t = tnet.init_table(7.0, device="cpu")
    assert t.dtype == torch.float32 and t.shape == (tnet.table_size,)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jnet.init_table(7.0)))


def test_stage_of_batch_matches_jax():
    b = boards(300, seed=5, max_exp=17)
    for th in [(), (12,), (12, 13), (5, 9, 16)]:
        np.testing.assert_array_equal(
            tnt.stage_of_batch(torch.from_numpy(b), th).numpy(),
            np.asarray(jnt.stage_of_batch(jnp.asarray(b), th)))


def test_stage_uses_the_unclipped_maximum():
    """A board with a 2**17 tile is in the stage of 17 although its feature
    indices clip the exponent to n_vals - 1 = 15."""
    b = np.zeros((1, 4, 4), np.int8)
    b[0, 0, 0] = 17
    net = tnb.NTupleNetwork(SMALL_TUPLES, 16, (16, 17))
    assert tnt.stage_of_batch(torch.from_numpy(b), (16, 17)).item() == 2
    idx = net.indices_batch(torch.from_numpy(b))
    assert idx.min().item() >= 2 * net.stage_stride
    np.testing.assert_array_equal(
        idx.numpy(),
        np.asarray(jnb.NTupleNetwork(SMALL_TUPLES, 16, (16, 17)).indices_batch(jnp.asarray(b))))


def test_promote_table_matches_jax():
    rng = np.random.default_rng(6)
    table = rng.normal(size=jnt.STAGE_STRIDE).astype(np.float32)
    got = tnt.promote_table(torch.from_numpy(table), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnt.promote_table(jnp.asarray(table), 3)))
    assert tnt.n_stages_of(got) == 3
    with pytest.raises(ValueError):
        tnt.promote_table(got, 2)  # already staged


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown n-tuple layout"):
        tnb.make_network("3x7")
    with pytest.raises(ValueError):
        tnb.NTupleNetwork(((0, 1, 16),))


def test_network_from_config():
    net = interop.network_from_config({"arch": "4x6", "n_vals": 16, "thresholds": [12, 13]})
    assert net.tuples == tnb.LAYOUTS["4x6"] and net.thresholds == (12, 13)
    net = interop.network_from_config({"tuples": [[0, 1, 2, 3]], "n_vals": 15})
    assert net.tuples == ((0, 1, 2, 3),) and net.n_vals == 15 and net.thresholds == ()
    small = interop.network_from_config({})  # no arch: the small net
    assert isinstance(small, tnt.SmallNet) and small.value_impl == "gather"
