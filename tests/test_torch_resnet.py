"""The port's CNN (gym2048_tpu_torch.models.resnet), its weight map
(gym2048_tpu_torch.interop) and entry point against the JAX package's on the
same weights and inputs.

Tolerances, with their reasons:

* Eval-mode forward, float32: within 1e-5 of the output's largest magnitude
  (at least 1). The two run the same operations, but XLA and torch sum a
  convolution's products in their own orders; measured 3e-8.
* Train-mode forward and the new BatchNorm statistics: within 1e-5 of the
  largest magnitude. flax computes the batch variance as E[x^2] - E[x]^2
  (``use_fast_variance``), the port as the normalisation's kernel does (in
  two passes; the running variance from its inverse deviation), and the
  sums again run in their own orders; measured 3e-6 (outputs) and 5e-6
  (statistics). Against ``torch.var_mean`` of the same activations the
  statistics agree to 1e-6 of their magnitude.
* bfloat16 compute: within 2^-12 of the largest magnitude, where the two
  round the same activations to bfloat16 but sum in their own orders;
  measured 2^-13 and below. The float32 forward of the same weights lies
  2^-11.1 (probabilities) and 2^-8.7 (logits, value) from flax's bfloat16
  outputs, and the test asserts that it lies outside the limit, so the
  limit holds the port to computing in bfloat16.
* The weight map and the model files: bit for bit (transposes and copies).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from gym2048_tpu.models import ActorCritic as JActorCritic
from gym2048_tpu.models import Game2048Model as JGame2048Model
from gym2048_tpu.models import boards_to_model_input as j_input
from gym2048_tpu.utils import checkpoint as jcheckpoint
from gym2048_tpu_torch import entry as port_entry
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.models import resnet
from gym2048_tpu_torch.utils import checkpoint

FIXTURE = "tests/fixtures/interop_game2048.npz"
MASKED_MODEL = "docs/curves/ppo_masked_model.pkl"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contending with each other
    ran a training test 30 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def boards(n, seed, max_exp=15):
    rng = np.random.default_rng(seed)
    return rng.integers(0, max_exp + 1, size=(n, 4, 4)).astype(np.int8)


def jax_model(kind, filters, blocks, dtype=jnp.float32):
    if kind == "ActorCritic":
        return JActorCritic(filters, blocks, dtype=dtype)
    return JGame2048Model(filters=filters, residual_blocks=blocks, dtype=dtype)


def jax_variables(model, seed):
    """flax's initial variables with every BatchNorm made non-trivial:
    scale, bias, mean and variance perturbed from a seed."""
    rng = np.random.default_rng(seed)
    v = model.init(jax.random.PRNGKey(seed), j_input(jnp.zeros((1, 4, 4), jnp.int8)))
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    return v


def outputs(x):
    return tuple(np.asarray(a) for a in (x if isinstance(x, tuple) else (x,)))


def port_outputs(model, b, dtype=torch.float32):
    with torch.no_grad():
        out = model(resnet.boards_to_model_input(torch.from_numpy(b), dtype))
    return tuple(a.numpy() for a in (out if isinstance(out, tuple) else (out,)))


def assert_close(got, want, rel):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == np.float32
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_array_less(np.abs(g - w).max(), rel * scale + 1e-30)


def assert_tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(path))


def test_boards_to_model_input_matches_jax():
    b = boards(64, 0, max_exp=17)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = resnet.boards_to_model_input(torch.from_numpy(b), tdt)
        want = np.asarray(j_input(jnp.asarray(b), jdt).astype(jnp.float32))
        assert got.dtype == tdt and got.shape == (64, 4, 4, 16)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
@pytest.mark.parametrize("filters,blocks", [(8, 1), (16, 2)])
def test_eval_forward_matches_flax(kind, filters, blocks):
    jm = jax_model(kind, filters, blocks)
    v = jax_variables(jm, filters + blocks)
    model = interop.resnet_from_variables(v, device="cpu")
    assert type(model).__name__ == kind and not model.training
    assert (model.filters, model.residual_blocks) == (filters, blocks)
    b = boards(128, 1)
    want = outputs(jm.apply(v, j_input(jnp.asarray(b)), train=False))
    assert_close(port_outputs(model, b), want, 1e-5)
    if kind == "Game2048Model":
        with torch.no_grad():
            logits = model.logits(resnet.boards_to_model_input(torch.from_numpy(b)))
        want_logits = jm.apply(v, j_input(jnp.asarray(b)), method=jm.logits)
        assert_close((logits.numpy(),), outputs(want_logits), 1e-5)


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_bf16_forward_matches_flax(kind):
    jm = jax_model(kind, 16, 2, jnp.bfloat16)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3),
                                         j_input(jnp.zeros((1, 4, 4), jnp.int8))))
    model = interop.resnet_from_variables(v, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    b = boards(256, 2)
    want = outputs(jm.apply(v, j_input(jnp.asarray(b), jnp.bfloat16), train=False))
    assert_close(port_outputs(model, b, torch.bfloat16), want, 2.0 ** -12)
    f32 = port_outputs(interop.resnet_from_variables(v, device="cpu"), b)
    assert max(np.abs(g - w).max() / max(1.0, float(np.abs(w).max()))
               for g, w in zip(f32, want, strict=True)) > 2.0 ** -12


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_train_forward_and_batch_stats_match_flax(kind):
    jm = jax_model(kind, 8, 2)
    v = jax_variables(jm, 4)
    model = interop.resnet_from_variables(v, device="cpu").train()
    b = boards(96, 5, max_exp=11)
    out, mutated = jm.apply(v, j_input(jnp.asarray(b)), train=True, mutable=["batch_stats"])
    assert_close(port_outputs(model, b), outputs(out), 1e-5)
    got = interop.resnet_variables(model)["batch_stats"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]),
                            jax.tree.leaves(got), strict=True):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), jax.tree_util.keystr(path)
    # the statistics moved by 0.01 of the batch's: flax's momentum 0.99
    before = jax.tree.leaves(v["batch_stats"])
    assert any(not np.allclose(a, c) for a, c in zip(before, jax.tree.leaves(got)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_batch_norm_statistics_follow_flax_rule(dtype):
    """One train-mode BatchNorm step: the output is the ReLU of torch's
    ``batch_norm`` of the batch (the layer holds the ReLU); the running statistics move by 0.01 towards the batch's
    mean and biased variance (``torch.var_mean``'s, within 1e-6 of their
    magnitude), taken from the normalisation's own statistics; a channel
    with no variance adds a variance of 0, never below."""
    gen = torch.Generator().manual_seed(3)
    bn = resnet.BatchNorm(16).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-1.0, 1.0, generator=gen)
    x = (torch.randn(256, 16, 4, 4, generator=gen) * 3 + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    x[:, 3] = 0.7
    out = bn(x)
    assert torch.equal(out, torch.relu(torch.nn.functional.batch_norm(
        x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)))
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    for got, want in ((bn.running_mean, torch.zeros(16).lerp(mean, 0.01)),
                      (bn.running_var, torch.ones(16).lerp(var, 0.01))):
        assert got.dtype == torch.float32
        assert (got - want).abs().max() <= 1e-6 * max(1.0, want.abs().max())
    assert (bn.running_var >= 0.99).all() and bn.running_var[3] == pytest.approx(0.99, abs=1e-7)


def test_committed_masked_model_matches_flax():
    """``docs/curves/ppo_masked_model.pkl`` (ActorCritic, 64 filters, 4
    blocks), read in place, over 256 boards."""
    variables, meta = checkpoint.load_model(MASKED_MODEL)
    assert meta == {"filters": 64, "residual_blocks": 4, "model": "ActorCritic"}
    model = interop.resnet_from_variables(variables, device="cpu")
    b = boards(256, 6, max_exp=11)
    jm = JActorCritic(meta["filters"], meta["residual_blocks"])
    want = outputs(jm.apply(variables, j_input(jnp.asarray(b)), train=False))
    assert_close(port_outputs(model, b), want, 1e-5)


def test_reference_fixture_loads_with_load_state_dict():
    """The reference torch ``Game2048Model.state_dict()`` loads with
    ``load_state_dict`` alone and gives its recorded probabilities."""
    with np.load(FIXTURE) as z:
        sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
        b, expected = z["boards"], z["expected_probs"]
    model = resnet.Game2048Model(filters=8, residual_blocks=1, device="cpu")
    model.load_state_dict(sd)
    probs = port_outputs(model, b)[0]
    np.testing.assert_allclose(probs, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_weight_map_round_trip_is_exact(kind):
    v = jax_variables(jax_model(kind, 8, 2), 7)
    model = interop.resnet_from_variables(v, device="cpu")
    assert_tree_equal(interop.resnet_variables(model), v)
    sd = interop.resnet_state_dict(v)
    assert set(sd) == set(model.state_dict())


def test_save_model_is_read_by_jax(tmp_path):
    """The port's ``save_model`` of ``resnet_variables`` is a file that the
    JAX package's ``load_model`` reads and evaluates to the port's outputs."""
    model = resnet.ActorCritic(8, 1, device="cpu", generator=torch.Generator().manual_seed(3))
    path = tmp_path / "m.pkl"
    checkpoint.save_model(path, interop.resnet_variables(model),
                          {"model": "ActorCritic", "filters": 8, "residual_blocks": 1})
    variables, meta = jcheckpoint.load_model(path)
    assert meta["model"] == "ActorCritic"
    b = boards(32, 8)
    want = outputs(JActorCritic(8, 1).apply(variables, j_input(jnp.asarray(b)), train=False))
    assert_close(port_outputs(model, b), want, 1e-5)
    with open(path, "rb") as f:
        assert_tree_equal(pickle.load(f)["variables"], interop.resnet_variables(model))


def test_entry_matches_graft_entry():
    """``entry()`` on the JAX entry's variables agrees with its ``fn``."""
    jfn, (variables, jboards) = __graft_entry__.entry()
    fn, (model, tboards) = port_entry.entry(device="cpu")
    assert isinstance(model, resnet.ActorCritic) and not model.training
    assert (model.filters, model.residual_blocks) == (64, 4)
    assert tboards.dtype == torch.int8 and tuple(tboards.shape) == tuple(jboards.shape)
    model.load_state_dict(interop.resnet_state_dict(jax.tree.map(np.asarray, variables)))
    b = boards(256, 9, max_exp=11)
    want = outputs(jfn(variables, jnp.asarray(b)))
    got = tuple(a.numpy() for a in fn(model, torch.from_numpy(b)))
    assert got[0].shape == (256, 4) and got[1].shape == (256,)
    assert_close(got, want, 1e-5)


def test_init_is_flax_lecun_normal():
    """Kernels truncated at two standard deviations of sqrt(1 / fan_in) /
    0.8796, biases 0, BatchNorm scale 1; the same generator seed gives the
    same weights."""
    model = resnet.ActorCritic(32, 1, device="cpu", generator=torch.Generator().manual_seed(0))
    w = model.res_blocks[0].conv1.weight.detach()
    std = (1.0 / (32 * 9)) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) - (1.0 / (32 * 9)) ** 0.5) < 0.05 * (1.0 / (32 * 9)) ** 0.5
    assert float(model.policy_head.bias.detach().abs().max()) == 0.0
    assert torch.equal(model.initial_bn.weight.detach(), torch.ones(32))
    again = resnet.ActorCritic(32, 1, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))


def test_build_model_mirrors_the_reference_signature():
    model = resnet.build_model(filters=8, residual_blocks=2, device="cpu")
    assert isinstance(model, resnet.Game2048Model)
    assert (model.filters, model.residual_blocks, model.outputs) == (8, 2, 4)
    probs = port_outputs(model, boards(4, 10))[0]
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError):
        resnet.build_model(board_size=5, device="cpu")
