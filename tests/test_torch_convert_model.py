"""The port's weight interop tool (gym2048_tpu_torch.tools.convert_model)
against gym2048_tpu.tools.convert_model: every case of tests/test_interop.py
re-run on the port (the recorded reference outputs of
tests/fixtures/interop_*.npz through the port's models, forward in eval
mode on the CPU, within test_interop.py's tolerances: rtol 1e-5 / atol 1e-6
for the probabilities, 1e-5 for the logits and values), the variable trees
equal to JAX's array for array, and the files crossing between the
packages both ways."""

import io
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gym2048_tpu.models import ActorCritic as JActorCritic
from gym2048_tpu.models.resnet import boards_to_model_input as jinput
from gym2048_tpu.tools import convert_model as jcm
from gym2048_tpu.utils import checkpoint as jck
from gym2048_tpu_torch import interop
from gym2048_tpu_torch.models.resnet import ActorCritic, Game2048Model, boards_to_model_input
from gym2048_tpu_torch.tools import convert_model as cm
from gym2048_tpu_torch.utils import checkpoint as tck

FIX = Path(__file__).parent / "fixtures"


def _load_fixture(name):
    with np.load(FIX / name) as z:
        sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
        rest = {k: z[k] for k in z.files if not k.startswith("sd::")}
    return sd, rest


def probs_of(variables, boards):
    model = interop.resnet_from_variables(variables, device="cpu")
    with torch.no_grad():
        return model(boards_to_model_input(torch.from_numpy(boards))).numpy()


def heads_of(variables, boards):
    model = interop.resnet_from_variables(variables, device="cpu")
    with torch.no_grad():
        logits, value = model(boards_to_model_input(torch.from_numpy(boards)))
    return logits.numpy(), value.numpy()


def assert_trees_equal(a, b):
    fa, fb = cm.flatten_variables(a), cm.flatten_variables(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


class TestGame2048Parity:
    def test_torch_to_flax_forward_parity(self):
        sd, rest = _load_fixture("interop_game2048.npz")
        variables, meta = cm.torch_to_flax_game2048(sd)
        assert meta == {"model": "Game2048Model", "filters": 8, "residual_blocks": 1}
        np.testing.assert_allclose(probs_of(variables, rest["boards"]), rest["expected_probs"],
                                   rtol=1e-5, atol=1e-6)
        want, want_meta = jcm.torch_to_flax_game2048(sd)
        assert meta == want_meta
        assert_trees_equal(variables, want)

    def test_flax_to_torch_round_trip_identity(self):
        sd, _ = _load_fixture("interop_game2048.npz")
        variables, _ = cm.torch_to_flax_game2048(sd)
        back = cm.flax_to_torch_game2048(variables)
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_array_equal(v, back[k], err_msg=k)
        want = jcm.flax_to_torch_game2048(variables)
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        # the reference state dict loads into the port's model as it is
        Game2048Model(filters=8, residual_blocks=1, device="cpu").load_state_dict(
            {k: torch.from_numpy(v) for k, v in back.items()})


class TestSB3Parity:
    @pytest.mark.parametrize("prefix", ["features_extractor", "pi_features_extractor"])
    def test_sb3_to_flax_forward_parity(self, prefix):
        sd, rest = _load_fixture("interop_sb3_policy.npz")
        if prefix != "features_extractor":
            sd = {k.replace("features_extractor", prefix, 1): v for k, v in sd.items()}
        variables, meta = cm.sb3_to_flax_actor_critic(sd)
        assert meta == {"model": "ActorCritic", "filters": 8, "residual_blocks": 1}
        logits, value = heads_of(variables, rest["boards"])
        np.testing.assert_allclose(logits, rest["expected_logits"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(value, rest["expected_values"], rtol=1e-5, atol=1e-5)
        want, want_meta = jcm.sb3_to_flax_actor_critic(sd)
        assert meta == want_meta
        assert_trees_equal(variables, want)

    def test_rejects_non_extractor_state_dict(self):
        with pytest.raises(KeyError):
            cm.sb3_to_flax_actor_critic({"foo.weight": np.zeros(3)})


class TestNpzRoundTrip:
    def test_npz_round_trip_bitexact(self, tmp_path):
        variables = interop.resnet_variables(ActorCritic(8, 1, device="cpu"))
        path = tmp_path / "m.npz"
        cm.save_npz(path, variables, {"model": "ActorCritic", "filters": 8})
        loaded, meta = cm.load_npz(path)
        assert meta == {"model": "ActorCritic", "filters": 8}
        assert_trees_equal(variables, loaded)

    def test_cli_npz_to_pkl(self, tmp_path, capsys):
        sd, rest = _load_fixture("interop_game2048.npz")
        variables, meta = cm.torch_to_flax_game2048(sd)
        src = tmp_path / "m.npz"
        cm.save_npz(src, variables, meta)
        dst = tmp_path / "m.pkl"
        cm.main([str(src), str(dst)])
        assert "wrote" in capsys.readouterr().out
        loaded, meta2 = tck.load_model(dst)
        assert meta2["model"] == "Game2048Model"
        np.testing.assert_allclose(probs_of(loaded, rest["boards"]), rest["expected_probs"],
                                   rtol=1e-5, atol=1e-6)

    def test_unsupported_extensions(self, tmp_path):
        with pytest.raises(SystemExit):
            cm.main([str(tmp_path / "m.txt"), str(tmp_path / "m.pkl")])
        sd, _ = _load_fixture("interop_game2048.npz")
        variables, meta = cm.torch_to_flax_game2048(sd)
        cm.save_npz(tmp_path / "m.npz", variables, meta)
        with pytest.raises(SystemExit):
            cm.main([str(tmp_path / "m.npz"), str(tmp_path / "m.zip")])


class TestTorchFiles:
    def test_cli_pth_to_npz_and_back(self, tmp_path):
        sd, rest = _load_fixture("interop_game2048.npz")
        pth = tmp_path / "ref.pth"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        npz = tmp_path / "m.npz"
        cm.main([str(pth), str(npz)])
        variables, meta = cm.load_npz(npz)
        assert meta["filters"] == 8
        np.testing.assert_allclose(probs_of(variables, rest["boards"]), rest["expected_probs"],
                                   rtol=1e-5, atol=1e-6)
        pth2 = tmp_path / "back.pth"
        cm.main([str(npz), str(pth2)])
        back = torch.load(pth2, weights_only=True)
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_array_equal(v, back[k].numpy(), err_msg=k)

    def test_whole_pickled_module(self, tmp_path):
        """``torch.save(model)``, as the reference's train.py saves, loads
        through ``load_torch_file`` (its class importable)."""
        sd, rest = _load_fixture("interop_game2048.npz")
        model = Game2048Model(filters=8, residual_blocks=1, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        torch.save(model, tmp_path / "whole.pt")
        variables, meta = cm.torch_to_flax_game2048(cm.load_torch_file(tmp_path / "whole.pt"))
        assert meta["residual_blocks"] == 1
        np.testing.assert_allclose(probs_of(variables, rest["boards"]), rest["expected_probs"],
                                   rtol=1e-5, atol=1e-6)

    def test_sb3_zip_import(self, tmp_path):
        sd, rest = _load_fixture("interop_sb3_policy.npz")
        buf = io.BytesIO()
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, buf)
        zpath = tmp_path / "ppo_model.zip"
        with zipfile.ZipFile(zpath, "w") as z:
            z.writestr("policy.pth", buf.getvalue())
            z.writestr("data", "{}")
        variables, _ = cm.sb3_to_flax_actor_critic(cm.load_sb3_zip(zpath))
        logits, _ = heads_of(variables, rest["boards"])
        np.testing.assert_allclose(logits, rest["expected_logits"], rtol=1e-5, atol=1e-5)
        cm.main([str(zpath), str(tmp_path / "p.pkl")])
        loaded, meta = jck.load_model(tmp_path / "p.pkl")  # JAX reads the port's file
        assert meta["model"] == "ActorCritic"
        jlogits, _ = JActorCritic(filters=8, residual_blocks=1).apply(
            loaded, jinput(rest["boards"]), train=False)
        np.testing.assert_allclose(np.asarray(jlogits), rest["expected_logits"], rtol=1e-5,
                                   atol=1e-5)
        with zipfile.ZipFile(tmp_path / "empty.zip", "w") as z:
            z.writestr("data", "{}")
        with pytest.raises(SystemExit):
            cm.load_sb3_zip(tmp_path / "empty.zip")

    def test_actor_critic_torch_export_is_refused(self, tmp_path):
        sd, _ = _load_fixture("interop_sb3_policy.npz")
        variables, meta = cm.sb3_to_flax_actor_critic(sd)
        with pytest.raises(SystemExit, match="export ActorCritic to .npz"):
            cm.save_torch_file(tmp_path / "x.pth", variables, meta)


@pytest.mark.parametrize("direction", ["jax writes", "port writes"])
@pytest.mark.parametrize("ext", [".npz", ".pkl", ".pth"])
def test_files_cross_between_the_packages(tmp_path, direction, ext):
    """A file one package's CLI writes from the reference's ``.pth``, the
    other's CLI reads back to the same variables."""
    sd, rest = _load_fixture("interop_game2048.npz")
    src = tmp_path / "ref.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    writer, reader = (jcm, cm) if direction == "jax writes" else (cm, jcm)
    mid = tmp_path / f"mid{ext}"
    writer.main([str(src), str(mid)])
    out = tmp_path / "out.npz"
    reader.main([str(mid), str(out)])
    variables, meta = cm.load_npz(out)
    assert meta == {"model": "Game2048Model", "filters": 8, "residual_blocks": 1}
    assert_trees_equal(variables, jcm.torch_to_flax_game2048(sd)[0])
    np.testing.assert_allclose(probs_of(variables, rest["boards"]), rest["expected_probs"],
                               rtol=1e-5, atol=1e-6)


def test_jax_initialised_weights_cross(tmp_path):
    """An ActorCritic initialised by flax, saved by JAX's ``save_npz``, is
    the port's model with JAX's forward."""
    model = JActorCritic(filters=8, residual_blocks=1)
    boards = np.random.default_rng(0).integers(0, 12, (6, 4, 4)).astype(np.int8)
    variables = model.init(jax.random.PRNGKey(0), jinput(boards), train=False)
    jcm.save_npz(tmp_path / "j.npz", variables, {"model": "ActorCritic"})
    loaded, _ = cm.load_npz(tmp_path / "j.npz")
    logits, value = heads_of(loaded, boards)
    jl, jv = model.apply(variables, jinput(boards), train=False)
    np.testing.assert_allclose(logits, np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value, np.asarray(jv), rtol=1e-5, atol=1e-5)
