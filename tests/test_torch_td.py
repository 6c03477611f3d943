"""The port's TD learner (gym2048_tpu_torch.train.td and the TD updates of
models.ntuple_big and models.ntuple) against gym2048_tpu.train.td on the
same numpy inputs.

Tolerances, with their reasons:

* Tables of small integers and dyadic TD errors keep every value sum and
  every scattered sum exact, so the updates, the greedy moves, the
  carousel and whole step bodies are compared bit for bit. The JAX side
  runs op by op (``jax.disable_jit``): compiled, XLA's CPU backend
  contracts ``table + alpha * rate * d`` in ``_tc_combine`` into one fused
  multiply-add, a rounding the expression as written does not have; the
  port keeps the expression's two roundings. Against the compiled JAX
  combine the tables agree within 1 ulp of the result plus 1 ulp of the
  product (``test_tc_combine_matches_jax``).
* With random f32 TD errors the scatters may add in different orders:
  within 1e-6 of the sum of the magnitudes that meet in an entry.
* The carousel's record writes every non-crossing env into row 0, and
  which of two writes to one slot stays is undefined on both sides: row 0
  of the reservoir is not compared, and the draws are checked to give the
  crossing envs distinct slots.
* A chunk of the small net from JAX's ``init_state`` (an empty table) is
  exact for its first two steps: every value is 0 until the first update
  lands. From then on each package adds a board's 136 entries in its own
  order, and a board's symmetric afterstates, equal in exact arithmetic,
  differ by an ulp either way: the greedy choice between them, and with it
  the game, may differ. So the later steps of JAX's own chunk are each
  re-run from JAX's carry with its table (and TC accumulators) replaced by
  small integers and ``prev_v`` by dyadic values, where both packages'
  arithmetic is exact: each step is compared bit for bit.
* Training draws its own random numbers in each package, so learning is
  checked by its statistics: greedy play after a short run beats random
  play.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.models import ntuple as jnt
from gym2048_tpu.models import ntuple_big as jnb
from gym2048_tpu.train import td as jtd
from gym2048_tpu.utils import checkpoint as jck
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.models import ntuple as tnt
from gym2048_tpu_torch.models import ntuple_big as tnb
from gym2048_tpu_torch.train import td as ttd
from gym2048_tpu_torch.utils import checkpoint as tck

# the small staged network of the agent tests, and the 4x6 layout at n_vals 4
SMALL = dict(tuples=((0, 1, 2, 3), (0, 1, 4, 5)), n_vals=16, thresholds=(6, 8))
NETS = {"small": SMALL,
        "4x6": dict(tuples=jnb.LAYOUTS["4x6"], n_vals=4, thresholds=(2, 3))}
# a trainer config both packages take: 4x6 at n_vals 4, stages at 2 and 3
BASE = dict(arch="4x6", n_vals=4, thresholds=(2, 3), alpha=0.5, alpha_final=0.5,
            init_value=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contending with each other
    ran a training test here 30 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nets(name):
    kw = NETS[name]
    return (jnb.NTupleNetwork(kw["tuples"], kw["n_vals"], kw["thresholds"]),
            tnb.NTupleNetwork(kw["tuples"], kw["n_vals"], kw["thresholds"]))


def boards(n, seed, max_exp=9, p_zero=0.3):
    rng = np.random.default_rng(seed)
    exps = rng.integers(1, max_exp + 1, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < p_zero, 0, exps).astype(np.int8)


def dead_boards(n, lo=1):
    """``n`` boards with no legal move: a checkerboard of exponents lo, lo+1."""
    b = (np.indices((4, 4)).sum(0) % 2 + lo).astype(np.int8)
    return np.broadcast_to(b, (n, 4, 4)).copy()


def dyadic(rng, n, eighths=64):
    return (rng.integers(-eighths, eighths, n) / 8).astype(np.float32)


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


# ---------------------------------------------------------------- updates

def _update(fn, net, table, tc_e, tc_a, b, d, alpha, valid, pending):
    """One update of ``fn`` on either package's network and arrays."""
    if fn == "td_update":
        return (net.td_update(table, b, d, alpha, valid=valid),)
    if fn == "td_update_tc":
        return net.td_update_tc(table, tc_e, tc_a, b, d, alpha, valid=valid)
    return net.tc_accumulate(pending, b, d, valid=valid)


def _update_inputs(net, seed, n, integer):
    rng = np.random.default_rng(seed)
    b = np.concatenate([boards(n - 2, seed, max_exp=10), dead_boards(2)])
    b[1] = b[0]  # two boards on the same entries: counts > 1
    if integer:
        table = rng.integers(-50, 50, net.table_size).astype(np.float32)
        tc_e = rng.integers(-8, 8, net.table_size).astype(np.float32)
        d = dyadic(rng, n)
    else:
        table = (rng.normal(size=net.table_size) * 100).astype(np.float32)
        tc_e = rng.normal(size=net.table_size).astype(np.float32)
        d = (rng.normal(size=n) * 100).astype(np.float32)
    tc_a = np.abs(tc_e) + rng.integers(0, 4, net.table_size).astype(np.float32)
    tc_a[::5] = 0.0
    tc_e[::5] = 0.0  # untouched entries: rate 1 where the step adds none
    pending = [rng.integers(-4, 4, net.table_size).astype(np.float32) for _ in range(3)]
    return table, tc_e, tc_a, b, d, pending


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["td_update", "td_update_tc", "tc_accumulate"])
@pytest.mark.parametrize("net_name", ["small", "4x6"])
def test_td_updates_match_jax_bit_for_bit(net_name, fn, masked):
    jnet, tnet = nets(net_name)
    table, tc_e, tc_a, b, d, pending = _update_inputs(jnet, 1, 24, integer=True)
    valid = np.random.default_rng(2).random(24) < 0.7 if masked else None
    with jax.disable_jit():
        want = _update(fn, jnet, *map(jnp.asarray, (table, tc_e, tc_a, b, d)), 0.5,
                       None if valid is None else jnp.asarray(valid),
                       tuple(map(jnp.asarray, pending)))
    got = _update(fn, tnet, *map(t, (table, tc_e, tc_a, b, d)), 0.5,
                  None if valid is None else t(valid), tuple(map(t, pending)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits(g, w, fn)


@pytest.mark.parametrize("fn", ["td_update", "td_update_tc", "tc_accumulate"])
def test_td_updates_match_jax_on_random_deltas(fn):
    jnet, tnet = nets("4x6")
    table, tc_e, tc_a, b, d, pending = _update_inputs(jnet, 3, 40, integer=False)
    valid = np.random.default_rng(4).random(40) < 0.8
    want = _update(fn, jnet, *map(jnp.asarray, (table, tc_e, tc_a, b, d)), 0.5,
                   jnp.asarray(valid), tuple(map(jnp.asarray, pending)))
    got = _update(fn, tnet, *map(t, (table, tc_e, tc_a, b, d)), 0.5, t(valid),
                  tuple(map(t, pending)))
    # the magnitudes that meet in each entry
    w = (8.0 / jnet.n_features) * np.abs(d) * valid
    absums = np.zeros(jnet.table_size, np.float64)
    np.add.at(absums, np.asarray(jnet.indices_batch(jnp.asarray(b))).reshape(-1),
              np.repeat(w, jnet.n_features))
    if fn == "td_update":
        starts = [table]
    elif fn == "td_update_tc":
        starts = [table, tc_e, tc_a]
    else:
        starts = pending
    for g, want_i, s in zip(got, want, starts):
        err = np.abs(g.numpy().astype(np.float64) - np.asarray(want_i))
        assert (err <= 1e-6 * (np.abs(s) + absums)).all()


def test_tc_combine_matches_jax():
    rng = np.random.default_rng(5)
    n = 50_000
    table, tc_e, sums = (rng.normal(size=(3, n)) * 100).astype(np.float32)
    sums[::3] = 0.0
    absums = (np.abs(sums) * rng.uniform(1, 2, n)).astype(np.float32)
    tc_a = np.abs(rng.normal(size=n)).astype(np.float32)
    tc_a[::7] = 0.0
    absums[::7] = 0.0
    cnts = rng.integers(0, 6, n).astype(np.float32)
    args = (table, tc_e, tc_a, sums, absums, cnts)
    for alpha in (1.0, 0.37):
        got = tnt._tc_combine(*map(t, args), torch.tensor(alpha, dtype=torch.float32))
        with jax.disable_jit():
            want = jnt._tc_combine(*map(jnp.asarray, args), jnp.float32(alpha))
        for g, w in zip(got, want):
            assert_bits(g, w)
        assert (got[0] == t(table)).sum() < n  # the table moved
        # compiled, XLA fuses the last multiply-add, which skips the rounding
        # of the product: within 1 ulp of the result and 1 of the product
        fused = np.asarray(jax.jit(jnt._tc_combine)(*map(jnp.asarray, args),
                                                    jnp.float32(alpha))[0])
        bound = np.spacing(np.abs(fused)) + np.spacing(np.abs(fused - table))
        assert (np.abs(got[0].numpy() - fused) <= bound).all()
        assert (got[0].numpy() != fused).any()  # the two roundings do differ


def test_tc_combine_leaves_its_inputs():
    x = [torch.ones(8) for _ in range(6)]
    tnt._tc_combine(*x, 0.5)
    assert all((v == 1).all() for v in x)


class TestTCAccumulate:
    """Delayed TC (arXiv:1604.05085): accumulation is additive and its
    deferred combine is one TC update of the concatenated steps (mirrors
    tests/test_ntuple_big.py::TestTCAccumulate on the port)."""

    def test_additivity_matches_single_scatter(self):
        net = tnb.make_network("4x6", n_vals=4)
        rng = np.random.default_rng(3)
        b1 = torch.from_numpy(rng.integers(0, 4, (8, 4, 4)).astype(np.int8))
        b2 = torch.from_numpy(rng.integers(0, 4, (8, 4, 4)).astype(np.int8))
        d1 = torch.from_numpy(rng.normal(size=8).astype(np.float32))
        d2 = torch.from_numpy(rng.normal(size=8).astype(np.float32))
        zeros = tuple(torch.zeros(net.table_size) for _ in range(3))
        p = net.tc_accumulate(zeros, b1, d1)
        p = net.tc_accumulate(p, b2, d2)
        w_all = (8.0 / net.n_features) * torch.cat([d1, d2])
        oracle = net._scatter3(torch.cat([b1, b2]), w_all, None)
        for got, want in zip(p, oracle):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)

    def test_deferred_combine_equals_concatenated_update(self):
        net = tnb.make_network("4x6", n_vals=4)
        rng = np.random.default_rng(4)
        b1 = torch.from_numpy(rng.integers(0, 4, (6, 4, 4)).astype(np.int8))
        b2 = torch.from_numpy(rng.integers(0, 4, (6, 4, 4)).astype(np.int8))
        d1 = torch.from_numpy(rng.normal(size=6).astype(np.float32))
        d2 = torch.from_numpy(rng.normal(size=6).astype(np.float32))
        v1 = torch.from_numpy(rng.integers(0, 2, 6).astype(bool))
        v2 = torch.from_numpy(rng.integers(0, 2, 6).astype(bool))
        table = torch.from_numpy(rng.normal(size=net.table_size).astype(np.float32))
        e0, a0 = torch.zeros_like(table), torch.zeros_like(table)
        zeros = tuple(torch.zeros_like(table) for _ in range(3))
        p = net.tc_accumulate(zeros, b1, d1, valid=v1)
        p = net.tc_accumulate(p, b2, d2, valid=v2)
        got = tnt._tc_combine(table, e0, a0, *p, 0.5)
        want = net.td_update_tc(table, e0, a0, torch.cat([b1, b2]), torch.cat([d1, d2]),
                                0.5, valid=torch.cat([v1, v2]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_update_impl_is_accepted_and_rows_gives_the_same_numbers():
    jnet, _ = nets("4x6")
    kw = NETS["4x6"]
    table, tc_e, tc_a, b, d, _ = _update_inputs(jnet, 6, 16, integer=True)
    outs = []
    for impl in ("scatter", "rows"):
        net = tnb.NTupleNetwork(kw["tuples"], kw["n_vals"], kw["thresholds"],
                                update_impl=impl)
        assert net.update_impl == impl
        outs.append(net.td_update_tc(t(table), t(tc_e), t(tc_a), t(b), t(d), 0.5))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert tnb.make_network("4x6", 4, update_impl="rows").update_impl == "rows"
    # as in JAX: a table that is not whole 128-lane rows records the scalar forms
    odd = tnb.NTupleNetwork(((0, 1, 2),), 3, update_impl="rows", value_impl="rows")
    jodd = jnb.NTupleNetwork(((0, 1, 2),), 3, update_impl="rows", value_impl="rows")
    assert (odd.update_impl, odd.value_impl) == (jodd.update_impl, jodd.value_impl)
    with pytest.raises(ValueError):
        tnb.make_network("4x6", 4, update_impl="mxu")


# ------------------------------------------------------------- the step

def test_greedy_batch_matches_jax():
    jnet, tnet = nets("small")
    table = np.random.default_rng(7).integers(-40, 40, jnet.table_size).astype(np.float32)
    b = np.concatenate([boards(30, 8, max_exp=9), dead_boards(3), dead_boards(1, lo=5)])
    want = jax.jit(lambda tb, bs: jtd._greedy_batch(lambda x: jnet.value_batch(tb, x), bs))(
        jnp.asarray(table), jnp.asarray(b))
    got = ttd._greedy_batch(tnet.make_value_fn(t(table)), t(b))
    for g, w, name in zip(got, want, ("action", "after", "reward", "v_after", "alive")):
        assert_bits(g, w, name)
    assert not got[4][-4:].any() and (got[0][-4:] == 0).all()  # dead: no move, action 0


def jax_draws(key, n, carousel):
    """The uniforms JAX's step body draws from ``key``, in the port's
    :meth:`TDTrainer._draws` layout; returns ``(next key, draws)``."""
    if carousel:
        key, kv, kp, kr, kcr, kcs = jax.random.split(key, 6)
    else:
        key, kv, kp, kr = jax.random.split(key, 4)
    u = jax.random.uniform
    d = {"spawn_val": u(kv, (n,)), "spawn_pos": u(kp, (n,)), "fresh": u(kr, (n, 4))}
    if carousel:
        ku, ks, kj = jax.random.split(kcs, 3)
        d.update(car_slot=u(kcr, (n,)), car_use=u(ku, (n,)), car_stage=u(ks, (n,)),
                 car_pick=u(kj, (n,)))
    return key, {k: t(v) for k, v in d.items()}


def test_carousel_units_match_jax():
    """Mirrors tests/test_td.py's carousel unit test, on the same draws."""
    key = jax.random.PRNGKey(0)
    car_b = jnp.zeros((3, 4, 4, 4), jnp.int8)
    car_f = jnp.zeros((3, 4), bool)
    next_state = jnp.arange(3 * 16, dtype=jnp.int8).reshape(3, 4, 4)
    st_prev = jnp.array([0, 1, 0], jnp.int32)
    st_next = jnp.array([1, 1, 0], jnp.int32)  # only env 0 crosses
    alive = jnp.ones(3, bool)
    jb, jf = jtd._carousel_record(car_b, car_f, st_prev, st_next, alive, next_state, key)
    u_slot = jax.random.uniform(key, (3,))
    tb, tf = ttd._carousel_record(t(car_b), t(car_f), t(st_prev), t(st_next), t(alive),
                                  t(next_state), t(u_slot))
    assert_bits(tf, jf)
    assert_bits(tb[1:], np.asarray(jb)[1:])
    f = tf.numpy()
    assert f[1].sum() == 1 and f[2].sum() == 0
    slot = int(f[1].argmax())
    np.testing.assert_array_equal(tb[1, slot].numpy(), np.asarray(next_state)[0])

    fresh = jnp.full((5, 4, 4), 7, jnp.int8)
    ku, ks, kj = jax.random.split(key, 3)
    u = [t(jax.random.uniform(k, (5,))) for k in (ku, ks, kj)]
    for p in (0.0, 0.5, 1.0):
        want = jtd._carousel_restart(jb, jf, fresh, key, p)
        got = ttd._carousel_restart(tb, tf, t(fresh), *u, p)
        assert_bits(got, want)
    assert (ttd._carousel_restart(tb, tf, t(fresh), *u, 0.0) == 7).all()
    stored = tb[1, slot]
    for board in ttd._carousel_restart(tb, tf, t(fresh), *u, 1.0):
        assert (board == stored).all() or (board == 7).all()


def step_carry(seed, n, cfg, jnet):
    """A train-state carry as numpy: integer table, dyadic values, boards of
    small exponents (so stages are crossed), some of them dead."""
    rng = np.random.default_rng(seed)
    b = np.concatenate([boards(n - 3, seed, max_exp=2, p_zero=0.5), dead_boards(3)])
    carry = {
        "table": rng.integers(-8, 8, jnet.table_size).astype(np.float32),
        "boards": b,
        "score": rng.integers(0, 400, n).astype(np.float32),
        "prev_after": boards(n, seed + 1, max_exp=3, p_zero=0.4),
        "prev_v": dyadic(rng, n),
        "prev_valid": rng.random(n) < 0.8,
        "key": np.asarray(jax.random.PRNGKey(seed)),
    }
    if cfg["tc"]:
        carry["tc_e"] = rng.integers(-4, 4, jnet.table_size).astype(np.float32)
        carry["tc_a"] = np.abs(carry["tc_e"]) + rng.integers(0, 3, jnet.table_size).astype(
            np.float32)
    if cfg.get("carousel"):
        s, r = jnet.n_stages, cfg["carousel_slots"]
        carry["car_boards"] = rng.integers(0, 4, (s, r, 4, 4)).astype(np.int8)
        carry["car_filled"] = rng.random((s, r)) < 0.5
    return carry


MODES = {
    "td": dict(tc=False),
    "tc": dict(tc=True),
    "tc_every_2": dict(tc=True, tc_every=2, chunk_steps=2),
    "carousel": dict(tc=True, carousel=0.5, carousel_slots=256),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_body_step_matches_jax(mode):
    """One step body (for ``tc_every``, a window of two steps through
    ``_scan_steps``) from one carry, on the uniforms JAX drew: every carry
    leaf and stat equal bit for bit. (After a combine the table holds
    quotients of counts, and value sums are no longer exact in any order,
    so later steps are compared within the port below.)"""
    kw = {**BASE, **MODES[mode]}
    n = 24
    jtr = jtd.TDTrainer(jtd.TDConfig(n_envs=n, **kw))
    ttr = ttd.TDTrainer(ttd.TDConfig(n_envs=n, **kw), device="cpu")
    carry = step_carry(11, n, kw, jtr._net)
    alpha = 0.5
    key = jnp.asarray(carry["key"])
    steps = kw.get("chunk_steps", 1) if mode == "tc_every_2" else 1
    draws = []
    for _ in range(steps):
        key, d = jax_draws(key, n, bool(kw.get("carousel")))
        draws.append(d)
    with jax.disable_jit():
        jcarry = {k: jnp.asarray(v) for k, v in carry.items()}
        if mode == "tc_every_2":
            want, wstats = jtr._scan_steps(jcarry, jnp.float32(alpha), steps)
        else:
            want, wstats = jtr._chunk_body(jnp.float32(alpha))(jcarry, None)
    tcarry = interop.train_state_from_numpy(carry, "cpu")
    a = torch.tensor(alpha, dtype=torch.float32)
    if mode == "tc_every_2":
        tcarry["generator"] = torch.Generator()
        it = iter(draws)
        ttr._draws = lambda gen, n_: next(it)
        got, gstats = ttr._scan_steps(tcarry, a, steps)
        del got["generator"]
    else:
        got, gstats = ttr._chunk_body(a)(tcarry, draws[0])
    assert set(got) == set(want) - {"key"}
    assert_bits(want["key"], key)  # the JAX key advanced as the draws assumed
    for k in got:
        if k == "car_boards":  # row 0 takes the non-crossing envs' writes
            assert_bits(got[k][1:], np.asarray(want[k])[1:], k)
        else:
            assert_bits(got[k], want[k], k)
    for g, w in zip(gstats, wstats):
        assert_bits(g, w)
    assert not torch.equal(got["table"], tcarry["table"])
    if mode == "carousel":
        d = draws[0]
        thr = ttr._net.thresholds
        nxt = ttd.rules.spawn(got["prev_after"], d["spawn_val"], d["spawn_pos"])
        st1 = tnt.stage_of_batch(nxt, thr)
        crossed = (st1 > tnt.stage_of_batch(tcarry["boards"], thr)) & got["prev_valid"]
        slots = (d["car_slot"] * kw["carousel_slots"]).long()[crossed]
        rows = st1[crossed]
        assert crossed.any(), "no env crossed a stage: the record went untested"
        assert len(set(zip(rows.tolist(), slots.tolist()))) == int(crossed.sum())
        assert (~got["prev_valid"]).any()  # some env restarted


def test_tc_windows_start_from_zero_pending():
    """A chunk of two delayed-TC windows equals two chunks of one window
    each from the same state: every window starts from zero pending sums."""
    kw = dict(BASE, tc=True, tc_every=2, carousel=0.5, carousel_slots=8, n_envs=16)
    one = ttd.TDTrainer(ttd.TDConfig(chunk_steps=4, **kw), device="cpu")
    two = ttd.TDTrainer(ttd.TDConfig(chunk_steps=2, **kw), device="cpu")
    a, _ = one.train_chunk(one.init_state(), 1.0)
    b = two.init_state()
    for _ in range(2):
        b, _ = two.train_chunk(b, 1.0)
    assert_states_equal(a, b)


def test_scan_steps_leaves_no_pending_buffers():
    cfg = ttd.TDConfig(n_envs=8, chunk_steps=4, tc=True, tc_every=2, **BASE)
    tr = ttd.TDTrainer(cfg, device="cpu")
    state, m = tr.train_chunk(tr.init_state(), 1.0)
    assert not {"tc_ps", "tc_pa", "tc_pc"} & set(state)
    assert set(m) == {"episodes", "ep_score_mean", "highest_exp"}
    assert m["highest_exp"].dtype == torch.int32


def test_trainer_checks_match_jax():
    """The checks of JAX's TDTrainer, big arch and small, as ValueError;
    the parts not ported raise and name their ROADMAP.md item."""
    for bad in (dict(tc_every=4, tc=False), dict(tc_every=4, tc=True, chunk_steps=10),
                dict(tc_every=4, tc=True, update_impl="rows"),
                dict(carousel=0.5, thresholds=()), dict(carousel=1.5)):
        with pytest.raises(ValueError):
            ttd.TDTrainer(ttd.TDConfig(**{**BASE, "chunk_steps": 8, **bad}), device="cpu")
        with pytest.raises(AssertionError):
            jtd.TDTrainer(jtd.TDConfig(**{**BASE, "chunk_steps": 8, **bad}))
    for bad in (dict(tc_every=2, tc=True), dict(carousel=0.5), dict(thresholds=(11, 12)),
                dict(update_impl="rows"), dict(value_impl="rows")):
        with pytest.raises(ValueError):
            ttd.TDTrainer(ttd.TDConfig(chunk_steps=8, **bad), device="cpu")
        with pytest.raises(AssertionError):
            jtd.TDTrainer(jtd.TDConfig(chunk_steps=8, **bad))
    tr = ttd.TDTrainer(ttd.TDConfig(), device="cpu")
    assert tr._net is None and tr._small.value_impl == "gather"  # auto: the exact lookup
    for impl in ("gather", "mxu", "mxu_bf16"):
        assert ttd.TDTrainer(ttd.TDConfig(value_impl=impl, update_impl="mxu"),
                             device="cpu")._small.value_impl == impl
    tr = ttd.TDTrainer(ttd.TDConfig(**BASE), device="cpu")
    for call in (lambda: tr.make_sharded_chunk(None), lambda: ttd.shard_td_state({}, None),
                 lambda: tr.learn(mesh=object())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()
    assert [f.name for f in dataclasses.fields(ttd.TDConfig)] == [
        f.name for f in dataclasses.fields(jtd.TDConfig)]
    assert ttd.TDConfig() == ttd.TDConfig(**dataclasses.asdict(jtd.TDConfig()))


# ------------------------------------------------- state files and the CLI

CKPT_CFG = dict(BASE, tc=True, tc_every=2, carousel=0.5, carousel_slots=8,
                n_envs=32, chunk_steps=4, alpha=1.0, alpha_final=1.0, total_steps=32 * 4 * 3,
                seed=3)


def assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "generator":
            assert torch.equal(a[k].get_state(), b[k].get_state())
        else:
            assert_bits(a[k], b[k], k)


def test_save_load_train_is_bit_continuous(tmp_path):
    cfg = ttd.TDConfig(**CKPT_CFG)
    straight, hist = ttd.TDTrainer(cfg, "cpu").learn(log_fn=None, max_chunks=2)
    tr = ttd.TDTrainer(cfg, "cpu")
    path = tmp_path / "state.pkl"
    tr.learn(log_fn=None, max_chunks=1, ckpt_path=path, ckpt_every=1)
    assert ttd.is_train_state(path)
    state, meta = ttd.load_train_state(path, "cpu")
    assert meta["chunks_done"] == 1 and meta["config"]["tc_every"] == 2
    resumed, rhist = tr.learn(state, log_fn=None, start_chunk=1, max_chunks=1)
    assert_states_equal(resumed, straight)
    assert rhist[-1].steps == hist[-1].steps and rhist[-1].episodes == hist[-1].episodes
    # the file is the JAX package's layout
    variables, jmeta = jck.load_model(path)
    assert jmeta["format"] == jtd.TRAIN_STATE_FORMAT
    assert variables["generator_state"].dtype == np.uint8


def test_load_a_jax_train_state(tmp_path):
    cfg = jtd.TDConfig(**{**CKPT_CFG, "n_envs": 16})
    jtr = jtd.TDTrainer(cfg)
    jstate, _ = jtr.train_chunk(jtr.init_state(jax.random.PRNGKey(3)), jnp.float32(1.0))
    jnp_state = {k: np.asarray(v) for k, v in jstate.items()}
    path = tmp_path / "jax_state.pkl"
    jtd.save_train_state(path, jstate, cfg, chunks_done=1)
    assert ttd.is_train_state(path)
    state, meta = ttd.load_train_state(path, "cpu")
    assert set(state) == set(jnp_state) - {"key"} | {"generator"}
    for k in set(jnp_state) - {"key"}:
        assert_bits(state[k], jnp_state[k], k)
    seeded = torch.Generator().manual_seed(ttd.resume_seed(cfg.seed, 1))
    assert torch.equal(state["generator"].get_state(), seeded.get_state())
    assert ttd.resume_seed(cfg.seed, 0) == cfg.seed
    tr = ttd.TDTrainer(ttd.TDConfig(**{**CKPT_CFG, "n_envs": 16}), "cpu")
    state, m = tr.train_chunk(state, 1.0)
    assert torch.isfinite(state["table"]).all() and float(m["highest_exp"]) >= 1
    # not train states: a bare table pickle and a file that is no pickle
    tck.save_model(tmp_path / "table.pkl", {"table": np.zeros(4, np.float32)})
    (tmp_path / "junk.pkl").write_bytes(b"not a pickle")
    assert not ttd.is_train_state(tmp_path / "table.pkl")
    assert not ttd.is_train_state(tmp_path / "junk.pkl")
    assert not ttd.is_train_state(tmp_path / "missing.pkl")
    with pytest.raises(ValueError):
        ttd.load_train_state(tmp_path / "table.pkl", "cpu")


def test_save_model_matches_the_jax_layout(tmp_path):
    table = np.arange(6, dtype=np.float32)
    tck.save_model(tmp_path / "t.pkl", {"table": torch.from_numpy(table), "n": 3},
                   meta={"config": {"arch": "4x6"}})
    for load in (jck.load_model, tck.load_model):
        variables, meta = load(tmp_path / "t.pkl")
        np.testing.assert_array_equal(variables["table"], table)
        assert variables["n"] == 3 and meta == {"config": {"arch": "4x6"}}
    with open(tmp_path / "t.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"variables", "meta"}


def test_cli_on_the_cpu_writes_a_table(tmp_path, capsys):
    out = tmp_path / "table.pkl"
    ckpt = tmp_path / "ckpt.pkl"
    args = ["--arch", "4x6", "--n-vals", "4", "--thresholds", "2", "3", "--tc",
            "--tc-every", "2", "--carousel", "0.5", "--carousel-slots", "8",
            "--envs", "16", "--chunk-steps", "4", "--steps", "128", "--alpha", "1",
            "--alpha-final", "1", "--init-value", "0", "--eval-episodes", "3",
            "--output", str(out), "--ckpt", str(ckpt), "--device", "cpu"]
    ttd.main(args)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 128 and res["output"] == str(out)
    for load in (jck.load_model, tck.load_model):
        variables, meta = load(out)
        assert variables["table"].shape == (3 * 4 * 4 ** 6,)
        assert meta["config"]["tc_every"] == 2 and tuple(meta["config"]["thresholds"]) == (2, 3)
    ttd.main(args[:-6] + ["--output", str(out), "--resume", str(ckpt), "--steps", "192",
                          "--device", "cpu"])
    assert "resumed full train state at chunk 2" in capsys.readouterr().out


@pytest.mark.parametrize("flags, item", [(["--sharded"], "Queue 1 item 7"),
                                         (["--arch", "4x6", "--sharded"], "Queue 1 item 7")])
def test_cli_names_what_is_not_ported(flags, item, capsys):
    with pytest.raises(SystemExit):
        ttd.main(flags + ["--device", "cpu"])
    assert item in capsys.readouterr().err


def test_learning_beats_random_play():
    """A short TD run on the 4x6 net: greedy play must clearly beat random
    play (mean score ~1000), as tests/test_td.py asks of the small net."""
    cfg = ttd.TDConfig(total_steps=256 * 64 * 12, n_envs=256, chunk_steps=64, arch="4x6",
                       n_vals=8, alpha=0.25, alpha_final=0.1, init_value=0.0, seed=1)
    tr = ttd.TDTrainer(cfg, device="cpu")
    state, history = tr.learn(log_fn=None)
    assert history[-1].steps == cfg.total_steps
    res = ttd.play_greedy(state["table"], 32, torch.Generator().manual_seed(5), move_cap=3000,
                          net=tr._net)
    assert res["Average score"] > 2000.0
    assert res["Highest tile"] >= 256


# ------------------------------------------------------------ the small net

def small_exact_carry(carry, seed, tc):
    """JAX's carry with its float leaves replaced where the step's
    arithmetic is exact in both packages: the table (and TC accumulators)
    small integers, ``prev_v`` dyadic. Boards, score, ``prev_after``,
    ``prev_valid`` and the key stay JAX's."""
    rng = np.random.default_rng(seed)
    size = jnt.STAGE_STRIDE
    out = dict(carry, table=rng.integers(-8, 8, size).astype(np.float32),
               prev_v=dyadic(rng, carry["prev_v"].shape[0]))
    if tc:
        out["tc_e"] = rng.integers(-4, 4, size).astype(np.float32)
        out["tc_a"] = np.abs(out["tc_e"]) + rng.integers(0, 3, size).astype(np.float32)
    return out


def assert_carries_equal(got, want, what):
    assert set(got) == set(want) - {"key"}, what
    for k in got:
        assert_bits(got[k], want[k], f"{what}: {k}")


SMALL_MODES = {"td": dict(tc=False), "tc": dict(tc=True, alpha=1.0, alpha_final=1.0),
               "td mxu": dict(tc=False, value_impl="mxu", update_impl="mxu"),
               "td mxu_bf16": dict(tc=False, value_impl="mxu_bf16")}


@pytest.mark.parametrize("mode", list(SMALL_MODES))
def test_small_chunk_matches_jax(mode):
    """A chunk of 8 steps of the small net from JAX's init_state, carried
    across by interop.train_state_from_numpy and fed the uniforms JAX drew
    (see the module docstring): the first two steps leave JAX's state in
    every leaf; each later step of JAX's chunk, re-run from JAX's carry
    with exact-arithmetic floats, leaves JAX's next carry in every leaf."""
    n, steps = 32, 8
    kw = {**dict(n_envs=n, init_value=0.0, alpha=0.5, alpha_final=0.5), **SMALL_MODES[mode]}
    jtr = jtd.TDTrainer(jtd.TDConfig(**kw))
    ttr = ttd.TDTrainer(ttd.TDConfig(**kw), device="cpu")
    alpha = kw["alpha"]
    jstate = jtr.init_state(jax.random.PRNGKey(7))
    a = torch.tensor(alpha, dtype=torch.float32)
    tcarry = interop.train_state_from_numpy({k: np.asarray(v) for k, v in jstate.items()}, "cpu")
    assert "generator" not in tcarry
    jbody = jtr._chunk_body(jnp.float32(alpha))
    tbody = ttr._chunk_body(a)
    jc, key = dict(jstate), jstate["key"]
    with jax.disable_jit():
        for step in range(2):
            key, draws = jax_draws(key, n, False)
            jc, wstats = jbody(jc, None)
            tcarry, gstats = tbody(tcarry, draws)
            assert_carries_equal(tcarry, jc, f"step {step}")
            for g, w in zip(gstats, wstats):
                assert_bits(g, w)
    assert (tcarry["table"] != 0).any()  # the second step's update landed
    jstep = jax.jit(jbody)
    for step in range(2, steps):
        carry = small_exact_carry({k: np.asarray(v) for k, v in jc.items()}, step, kw["tc"])
        _, draws = jax_draws(jnp.asarray(carry["key"]), n, False)
        with jax.disable_jit():
            want, _ = jbody({k: jnp.asarray(v) for k, v in carry.items()}, None)
        got, _ = tbody(interop.train_state_from_numpy(carry, "cpu"), draws)
        assert_carries_equal(got, want, f"step {step}")
        jc, _ = jstep(jc, None)  # JAX's own chunk goes on
    assert (~np.asarray(want["prev_valid"])).sum() < n


@pytest.mark.parametrize("impl", ["gather", "mxu", "mxu_bf16"])
def test_small_greedy_batch_matches_jax(impl):
    table = np.random.default_rng(12).integers(-40, 40, jnt.STAGE_STRIDE).astype(np.float32)
    b = np.concatenate([boards(30, 13, max_exp=12), dead_boards(3), dead_boards(1, lo=5)])

    def jvalue(tb, bs):
        if impl == "gather":
            return jnt.value_batch(tb, bs)
        hi, lo = jnt.split_table(tb)
        return jnt.value_batch_mxu(hi, None if impl == "mxu_bf16" else lo, bs)

    want = jax.jit(lambda tb, bs: jtd._greedy_batch(lambda x: jvalue(tb, x), bs))(
        jnp.asarray(table), jnp.asarray(b))
    got = ttd._greedy_batch(tnt.SmallNet(impl).make_value_fn(t(table)), t(b))
    for g, w, name in zip(got, want, ("action", "after", "reward", "v_after", "alive")):
        assert_bits(g, w, name)


def test_small_learning_beats_random_play():
    """tests/test_td.py's check of the small net, on the port: after a
    short run greedy play clearly beats random play (mean ~1000)."""
    cfg = ttd.TDConfig(total_steps=256 * 64 * 12, n_envs=256, chunk_steps=64, alpha=0.25,
                       alpha_final=0.1, init_value=20000.0, seed=1)
    tr = ttd.TDTrainer(cfg, device="cpu")
    state, history = tr.learn(log_fn=None)
    assert history[-1].steps == cfg.total_steps
    assert state["table"].shape == (jnt.STAGE_STRIDE,)
    res = ttd.play_greedy(state["table"], 32, torch.Generator().manual_seed(5), move_cap=3000)
    assert res["Average score"] > 2000.0
    assert res["Highest tile"] >= 256


def test_small_play_greedy_modes_agree():
    """The exact modes play the same games on one table; the bf16 one
    plays legal games."""
    table = torch.from_numpy(
        np.random.default_rng(14).integers(0, 500, jnt.STAGE_STRIDE).astype(np.float32))
    res = {impl: ttd.play_greedy(table, 4, torch.Generator().manual_seed(2), move_cap=200,
                                 value_impl=impl)
           for impl in ("auto", "gather", "mxu", "mxu_bf16")}
    assert res["auto"] == res["gather"] == res["mxu"]  # integers < 256 split exactly...
    assert all(e["moves"] > 0 for e in res["mxu_bf16"]["Episodes"])


def test_small_cli_trains_saves_resumes_and_evaluates(tmp_path, capsys):
    out = tmp_path / "small.pkl"
    ckpt = tmp_path / "ckpt.pkl"
    args = ["--envs", "16", "--chunk-steps", "4", "--steps", "128", "--alpha", "0.5",
            "--alpha-final", "0.25", "--init-value", "100", "--eval-episodes", "3",
            "--value-impl", "mxu", "--update-impl", "mxu", "--device", "cpu"]
    ttd.main(args + ["--output", str(out), "--ckpt", str(ckpt)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 128 and res["Average score"] > 0
    variables, meta = jck.load_model(out)  # the JAX package's loader
    assert variables["table"].shape == (jnt.STAGE_STRIDE,)
    assert meta["config"]["arch"] == "small" and meta["config"]["value_impl"] == "mxu"
    # JAX plays the port's table
    jres = jtd.play_greedy(jnp.asarray(variables["table"]), 2, jax.random.PRNGKey(0),
                           move_cap=50)
    assert jres["Average score"] >= 0
    ttd.main(args + ["--output", str(out), "--resume", str(ckpt), "--ckpt", str(ckpt),
                     "--steps", "192"])
    assert "resumed full train state at chunk 2" in capsys.readouterr().out
    state, meta = ttd.load_train_state(ckpt, "cpu")
    assert meta["chunks_done"] == 3 and state["table"].shape == (jnt.STAGE_STRIDE,)
    # a bare table seeds the table
    ttd.main(args[:-2] + ["--device", "cpu", "--output", str(tmp_path / "b.pkl"),
                          "--resume", str(out), "--steps", "64"])
    with pytest.raises(SystemExit):
        ttd.main(["--value-impl", "rows", "--device", "cpu"])
    assert '"rows" applies to the big-net' in capsys.readouterr().err


def test_small_train_state_crosses_both_ways(tmp_path):
    """A JAX small-net train state loads in the port and trains on; the
    port's loads in JAX's loaders, every leaf equal."""
    cfg = dict(n_envs=16, chunk_steps=4, tc=True, alpha=1.0, alpha_final=1.0,
               init_value=100.0, total_steps=16 * 4 * 3, seed=3)
    jtr = jtd.TDTrainer(jtd.TDConfig(**cfg))
    jstate, _ = jtr.train_chunk(jtr.init_state(jax.random.PRNGKey(3)), jnp.float32(1.0))
    path = tmp_path / "jax_small.pkl"
    jtd.save_train_state(path, jstate, jtd.TDConfig(**cfg), chunks_done=1)
    state, meta = ttd.load_train_state(path, "cpu")
    for k in set(jstate) - {"key"}:
        assert_bits(state[k], np.asarray(jstate[k]), k)
    tr = ttd.TDTrainer(ttd.TDConfig(**cfg), "cpu")
    state, hist = tr.learn(state, log_fn=None, start_chunk=1, ckpt_path=tmp_path / "t.pkl",
                           ckpt_every=1)
    assert hist[-1].steps == cfg["total_steps"] and torch.isfinite(state["table"]).all()
    jvars, jmeta = jtd.load_train_state(tmp_path / "t.pkl")
    assert jmeta["chunks_done"] == 3 and jmeta["config"]["arch"] == "small"
    for k in ("table", "tc_e", "tc_a", "boards", "score", "prev_after", "prev_v", "prev_valid"):
        assert_bits(state[k], np.asarray(jvars[k]), k)
