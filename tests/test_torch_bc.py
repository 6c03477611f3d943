"""The port's BC trainer (gym2048_tpu_torch.train.bc) against the JAX
package's (gym2048_tpu.train.bc) on the same weights, data and permutation,
and the JAX tests of tests/test_train.py::TestBCTrainer on the port.

Tolerances, with their reasons:

* One epoch's mean loss: within 1e-5 of its magnitude; its accuracy and
  ``evaluate``'s: equal (the same argmax on logits that agree to 1e-6).
* Parameters after the epoch's three Adam steps (the last one padded and
  masked): within 0.1 of the learning rate per step, the median element
  within 1e-3 of it; as in tests/test_torch_ppo.py, Adam turns the
  gradient roundoff of an element within ~eps of zero into up to a step.
* BatchNorm statistics: within 1e-5 of their magnitude.
* ``evaluate``'s loss: within 1e-5 of its magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym2048_tpu.models import ActorCritic as JActorCritic
from gym2048_tpu.models import Game2048Model as JGame2048Model
from gym2048_tpu.train import bc as jbc
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.models.resnet import ActorCritic, Game2048Model
from gym2048_tpu_torch.train import bc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the test workers share
    the CPU's cores, and torch's thread pools contending with each other
    ran a training test 30 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synthetic_dataset(n=512, seed=0):
    """Boards labelled by a simple deterministic rule (fully learnable):
    the rule of tests/test_train.py."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 8, size=(n, 4, 4)).astype(np.int8)
    labels = boards.reshape(n, 16).argmax(axis=1) % 4
    return boards, labels


def jax_setup(kind):
    jm = JActorCritic(8, 1) if kind == "ActorCritic" else JGame2048Model(filters=8,
                                                                        residual_blocks=1)
    jtrainer = jbc.BCTrainer(jm, jbc.BCConfig(epochs=1, batch_size=64))
    variables = jax.tree.map(np.asarray, jtrainer.init_variables(jax.random.PRNGKey(2)))
    trainer = bc.BCTrainer(interop.resnet_from_variables(variables, device="cpu"),
                           bc.BCConfig(epochs=1, batch_size=64))
    return jtrainer, trainer, variables


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_epoch_matches_jax(kind):
    """One epoch over 130 samples in minibatches of 64 (the last padded
    with 62 repeats and masked) with JAX's permutation."""
    jtrainer, trainer, variables = jax_setup(kind)
    boards, labels = synthetic_dataset(130, 1)
    key = jax.random.PRNGKey(4)
    params, stats, _, loss, acc = jtrainer._epoch(
        variables["params"], variables["batch_stats"], jtrainer.tx.init(variables["params"]),
        jnp.asarray(boards), jnp.asarray(labels, jnp.int32), key)
    perm = np.asarray(jax.random.permutation(key, 130))
    model, history = trainer.fit(boards, labels, verbose=False, perms=[perm])
    assert model is trainer.model and not model.training
    assert abs(history[0]["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    assert history[0]["accuracy"] == pytest.approx(float(acc), abs=1e-7)
    got = interop.resnet_variables(model)
    lr = trainer.cfg.lr
    diffs = np.concatenate([np.abs(np.asarray(w) - g).ravel() for w, g in zip(
        jax.tree.leaves(params), jax.tree.leaves(got["params"]), strict=True)])
    assert diffs.max() <= 0.1 * lr * 3 and np.median(diffs) <= 1e-3 * lr
    for w, g in zip(jax.tree.leaves(stats), jax.tree.leaves(got["batch_stats"]), strict=True):
        assert np.abs(np.asarray(w) - g).max() <= 1e-5 * max(1.0, np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("kind", ["ActorCritic", "Game2048Model"])
def test_evaluate_matches_jax(kind):
    jtrainer, trainer, variables = jax_setup(kind)
    boards, labels = synthetic_dataset(200, 2)
    want = jtrainer.evaluate(variables, boards, labels)
    got = trainer.evaluate(boards, labels)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert got["accuracy"] == want["accuracy"]


def test_learns_synthetic_rule():
    boards, labels = synthetic_dataset(512)
    trainer = bc.BCTrainer(Game2048Model(filters=16, residual_blocks=1, device="cpu"),
                           bc.BCConfig(epochs=6, batch_size=64, lr=3e-3))
    trainer.init_model(torch.Generator().manual_seed(0))
    _, history = trainer.fit(boards, labels, verbose=False)
    assert history[-1]["accuracy"] > 0.6  # way above 0.25 chance
    assert history[-1]["loss"] < history[0]["loss"]
    assert trainer.evaluate(boards, labels)["accuracy"] > 0.6


def test_partial_last_batch_handled():
    boards, labels = synthetic_dataset(130)  # 130 % 64 != 0
    trainer = bc.BCTrainer(Game2048Model(filters=8, residual_blocks=1, device="cpu"),
                           bc.BCConfig(epochs=1, batch_size=64))
    _, history = trainer.fit(boards, labels, verbose=False)
    assert np.isfinite(history[0]["loss"]) and 0.0 <= history[0]["accuracy"] <= 1.0


def test_bc_on_actor_critic():
    boards, labels = synthetic_dataset(256)
    trainer = bc.BCTrainer(ActorCritic(filters=8, residual_blocks=1, device="cpu"),
                           bc.BCConfig(epochs=3, batch_size=64, lr=3e-3))
    _, history = trainer.fit(boards, labels, verbose=False)
    assert history[-1]["accuracy"] > history[0]["accuracy"] - 0.05
    assert 0 <= trainer.evaluate(boards, labels)["accuracy"] <= 1


def test_fit_is_deterministic_for_a_seed():
    boards, labels = synthetic_dataset(200, 3)

    def run(seed):
        trainer = bc.BCTrainer(Game2048Model(filters=8, residual_blocks=1, device="cpu"),
                               bc.BCConfig(epochs=2, batch_size=64, seed=seed))
        return trainer.fit(boards, labels, verbose=False)[1]

    assert run(0) == run(0)
    assert run(0) != run(1)


def test_build_bc_trainer_for_ppo():
    trainer = bc.build_bc_trainer_for_ppo(device="cpu")
    assert isinstance(trainer.model, ActorCritic)
    assert (trainer.model.filters, trainer.model.residual_blocks) == (64, 4)
    assert trainer.cfg == bc.BCConfig(epochs=10, batch_size=256, lr=1e-3)
    assert trainer.device.type == "cpu"
