"""The port's ops (gym2048_tpu_torch.ops) against gym2048_tpu.ops on the same
numpy inputs, and the golden values of tests/test_ops.py.

Tolerances, with their reasons:

* Observation encoders and the augmentation compare and move integers:
  equal exactly.
* Returns and GAE take the same f32 operations in the same order: equal
  bit for bit against JAX run op by op (``jax.disable_jit``); compiled, XLA
  may contract a multiply and an add into one rounding, so against the
  jitted JAX within 1e-6 relative (of the magnitudes a step adds).
* ``log2`` (XLA: log(x) / log(2); torch: its own log2) and the moments of
  ``normalize`` (summation order): within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.ops import augment as jaug
from gym2048_tpu.ops import obs as jobs
from gym2048_tpu.ops import returns as jret
from gym2048_tpu_torch.ops import augment, obs, returns

BOARD1 = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])
BOARD2 = np.array([[0, 0, 0, 0], [2, 4, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contending with each other
    ran a training test here 30 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def boards(n, seed, max_exp=17):
    rng = np.random.default_rng(seed)
    return rng.integers(0, max_exp + 1, size=(n, 4, 4)).astype(np.int8)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def assert_equal(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.uint32 if got.itemsize == 4 else np.uint16),
                                      want.view(np.uint32 if want.itemsize == 4 else np.uint16))
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ obs

@pytest.mark.parametrize("dtype", [(torch.float32, jnp.float32), (torch.float16, jnp.float16),
                                   (torch.int8, jnp.int8)])
def test_stacks_match_jax(dtype):
    tdt, jdt = dtype
    b = boards(64, 0).reshape(4, 16, 4, 4)  # leading batch dims, exponents 0-17
    assert_equal(obs.env_stack(t(b), tdt), jobs.env_stack(jnp.asarray(b), jdt))
    assert_equal(obs.dataset_stack(t(b), tdt), jobs.dataset_stack(jnp.asarray(b), jdt))
    assert obs.env_stack(t(b[0, 0]), tdt).shape == (16, 4, 4)


def test_inverses_match_jax():
    b = boards(64, 1, max_exp=15)
    stacked = obs.env_stack(t(b))
    assert_equal(obs.unstack_env(stacked), jobs.unstack_env(jnp.asarray(stacked.numpy())))
    assert torch.equal(obs.unstack_env(stacked), t(b))
    ds = obs.dataset_stack(t(b))
    assert_equal(obs.dataset_to_env(ds), jobs.dataset_to_env(jnp.asarray(ds.numpy())))
    assert torch.equal(obs.dataset_to_env(ds), stacked)
    # not one-hot: the weighted channel sums, as in JAX
    rng = np.random.default_rng(2)
    junk = (rng.random((8, 16, 4, 4)) < 0.2).astype(np.float32)
    assert_equal(obs.unstack_env(t(junk)), jobs.unstack_env(jnp.asarray(junk)))
    junk = (rng.random((8, 4, 4, 16)) < 0.1).astype(np.float32)
    assert_equal(obs.dataset_to_env(t(junk)), jobs.dataset_to_env(jnp.asarray(junk)))


# -------------------------------------------------------------- augment

@pytest.mark.parametrize("k", [-1, 0, 1, 2, 3, 4])
def test_flips_and_rotations_match_jax(k):
    b = boards(32, 3)
    a = np.random.default_rng(4).integers(0, 4, (32, 2))
    assert_equal(augment.hflip_boards(t(b)), jaug.hflip_boards(jnp.asarray(b)))
    assert_equal(augment.hflip_actions(t(a.astype(np.int32))),
                 jaug.hflip_actions(jnp.asarray(a, jnp.int32)))
    assert_equal(augment.rotate_boards(t(b), k), jaug.rotate_boards(jnp.asarray(b), k))
    assert_equal(augment.rotate_actions(t(a.astype(np.int32)), k),
                 jaug.rotate_actions(jnp.asarray(a, jnp.int32), k))


@pytest.mark.parametrize("with_next", [False, True])
def test_augment8_matches_jax(with_next):
    b, n = boards(16, 5), boards(16, 6)
    a = np.random.default_rng(7).integers(0, 4, 16).astype(np.int32)
    got = augment.augment8(t(b), t(a), t(n) if with_next else None)
    want = jaug.augment8(jnp.asarray(b), jnp.asarray(a), jnp.asarray(n) if with_next else None)
    assert len(got) == len(want) == (3 if with_next else 2)
    for g, w in zip(got, want):
        assert_equal(g, w)


def test_augment_goldens():
    """tests/test_ops.py's expected values, on the port."""
    pair = t(np.stack([BOARD1, BOARD2]))
    acts = torch.tensor([[1], [2]])
    fb = augment.hflip_boards(pair).numpy()
    np.testing.assert_array_equal(fb[0], [[0, 0, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])
    np.testing.assert_array_equal(fb[1], [[0, 0, 0, 0], [0, 0, 4, 2], [0, 0, 0, 0], [0, 0, 0, 0]])
    np.testing.assert_array_equal(augment.hflip_actions(acts).numpy(), [[3], [2]])
    rb = augment.rotate_boards(pair, 3).numpy()
    np.testing.assert_array_equal(rb[0], [[0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]])
    np.testing.assert_array_equal(rb[1], [[0, 0, 0, 0], [0, 0, 0, 0], [0, 4, 0, 0], [0, 2, 0, 0]])
    np.testing.assert_array_equal(augment.rotate_actions(acts, 3).numpy(), [[0], [1]])

    nxt = np.array([[0, 0, 0, 2], [0, 2, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])
    b, a, n = augment.augment8(t(BOARD1[None]), torch.tensor([[1]]), t(nxt[None]))
    expected_x = np.array([
        [[1, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
        [[0, 0, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
        [[0, 0, 0, 1], [0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0]],
        [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 1]],
        [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 1, 1]],
        [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [1, 1, 0, 0]],
        [[0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]],
        [[1, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
    ])
    expected_y = np.array([[1], [3], [2], [0], [3], [1], [0], [2]])
    expected_next = np.array([
        [[0, 0, 0, 2], [0, 2, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
        [[2, 0, 0, 0], [0, 0, 2, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
        [[0, 0, 0, 0], [0, 0, 2, 0], [0, 0, 0, 0], [0, 0, 0, 2]],
        [[0, 0, 0, 2], [0, 0, 0, 0], [0, 0, 2, 0], [0, 0, 0, 0]],
        [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 2, 0], [2, 0, 0, 0]],
        [[0, 0, 0, 0], [0, 0, 0, 0], [0, 2, 0, 0], [0, 0, 0, 2]],
        [[2, 0, 0, 0], [0, 0, 0, 0], [0, 2, 0, 0], [0, 0, 0, 0]],
        [[0, 0, 0, 0], [0, 2, 0, 0], [0, 0, 0, 0], [2, 0, 0, 0]],
    ])
    np.testing.assert_array_equal(b.numpy(), expected_x)
    np.testing.assert_array_equal(a.numpy(), expected_y)
    np.testing.assert_array_equal(n.numpy(), expected_next)


def test_augment_preserves_transitions():
    """Each augmented (board, action, next) is a transition of the port's
    rules: the symmetry equivariance tests/test_ops.py checks in JAX."""
    from gym2048_tpu_torch.core import rules

    board = torch.tensor([[1, 1, 2, 0], [0, 2, 2, 1], [1, 0, 3, 3], [1, 1, 1, 1]],
                         dtype=torch.int8)
    moved, _, legal = rules.move_all(board[None])
    acts = torch.nonzero(legal[0])[:, 0]
    b, a, n = augment.augment8(board[None].expand(len(acts), 4, 4), acts, moved[0, acts])
    after, _, ok = rules.move_all(b)
    col = a[:, None]
    assert ok.gather(1, col).all()
    assert torch.equal(after[torch.arange(len(a)), a], n)


# -------------------------------------------------------------- returns

def test_log2_rewards_matches_jax():
    rng = np.random.default_rng(8)
    r = np.concatenate([[0.0, -4.0, 2.0, 4.0, 16.0, 75.0, 2048.0, 1e-35],
                        rng.integers(0, 70000, 200)]).astype(np.float32)
    got = returns.log2_rewards(t(r)).numpy()
    want = np.asarray(jret.log2_rewards(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.dtype == np.float32 and (got[r <= 0] == 0).all()
    np.testing.assert_allclose(returns.log2_rewards(t(np.array([0.0, 2, 4, 16, 75, 2048],
                                                               np.float32))).numpy(),
                               [0, 1, 2, 4, 6.2288, 11], rtol=1e-4)  # tests/test_ops.py


def test_discounted_returns_matches_jax():
    rng = np.random.default_rng(9)
    r = rng.integers(0, 300, 64).astype(np.float32)
    d = rng.random(64) < 0.1
    for gamma in (0.9, 0.0, 0.99):
        got = returns.discounted_returns(t(r), t(d), gamma)
        with jax.disable_jit():
            assert_equal(got, jret.discounted_returns(jnp.asarray(r), jnp.asarray(d), gamma))
        want = np.asarray(jret.discounted_returns(jnp.asarray(r), jnp.asarray(d), gamma))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # tests/test_ops.py's goldens
    r4 = torch.tensor([4.0, 2, 16, 2])
    np.testing.assert_allclose(returns.discounted_returns(r4, torch.zeros(4, dtype=bool), 0.9),
                               [20.218, 18.02, 17.8, 2.0], rtol=1e-5)
    np.testing.assert_allclose(returns.discounted_returns(r4, torch.zeros(4, dtype=bool), 0.0),
                               [4, 2, 16, 2])
    np.testing.assert_allclose(
        returns.discounted_returns(r4, torch.tensor([False, True, False, True]), 0.9),
        [5.8, 2.0, 17.8, 2.0], rtol=1e-6)


@pytest.mark.parametrize("shape", [(32,), (32, 5)])
def test_gae_matches_jax(shape):
    rng = np.random.default_rng(10)
    r = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    d = rng.random(shape) < 0.15
    last = rng.normal(size=shape[1:]).astype(np.float32)
    got = returns.gae(t(r), t(v), t(d), t(last), 0.99, 0.95)
    with jax.disable_jit():
        want = jret.gae(*map(jnp.asarray, (r, v, d, last)), 0.99, 0.95)
    for g, w in zip(got, want):
        assert_equal(g, w)
    jitted = jret.gae(*map(jnp.asarray, (r, v, d, last)), 0.99, 0.95)
    scale = np.abs(r) + np.abs(v) + 10.0  # magnitudes a step adds, over ~20 steps
    for g, w in zip(got, jitted):
        assert (np.abs(g.numpy() - np.asarray(w)) <= 1e-6 * scale).all()


def test_gae_golden():
    """tests/test_ops.py's manual backward pass, on the port."""
    adv, ret = returns.gae(torch.tensor([1.0, 0.0, 2.0]), torch.tensor([0.5, 0.6, 0.7]),
                           torch.tensor([False, False, True]), torch.tensor(9.9),
                           gamma=0.99, lam=0.95)
    a2 = 2.0 - 0.7
    a1 = 0.0 + 0.99 * 0.7 - 0.6 + 0.99 * 0.95 * a2
    a0 = 1.0 + 0.99 * 0.6 - 0.5 + 0.99 * 0.95 * a1
    np.testing.assert_allclose(adv.numpy(), [a0, a1, a2], rtol=1e-6)
    np.testing.assert_allclose(ret.numpy(), adv.numpy() + [0.5, 0.6, 0.7], rtol=1e-6)


def test_normalize_matches_jax():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(64, 8)) * 50 + 7).astype(np.float32)
    np.testing.assert_allclose(returns.normalize(t(x)).numpy(),
                               np.asarray(jret.normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert_equal(returns.normalize(t(x), mean=3.0, sd=2.0),
                 jret.normalize(jnp.asarray(x), mean=3.0, sd=2.0))
    r = torch.tensor([4.0, 4, 8, 16])  # tests/test_ops.py's goldens
    np.testing.assert_allclose(returns.normalize(r).numpy(), [-0.8165, -0.8165, 0.0, 1.633],
                               rtol=1e-3)
    np.testing.assert_allclose(returns.normalize(r, mean=8.0, sd=1.0).numpy(), [-4, -4, 0, 8])
