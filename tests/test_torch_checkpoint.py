"""The port's loaders (gym2048_tpu_torch.utils.checkpoint) against the JAX
package's savers and loaders: the bf16 artifact decodes bit for bit as
JAX's ``load_array_bf16`` decodes it (which uses ml_dtypes; the port does
not), and a ``save_model`` pickle loads back."""

import numpy as np
import pytest

from gym2048_tpu.utils import checkpoint as jck
from gym2048_tpu_torch.utils import checkpoint as tck


@pytest.mark.parametrize("delta_stages", [1, 3])
def test_load_array_bf16_matches_jax(tmp_path, delta_stages):
    rng = np.random.default_rng(delta_stages)
    stage = (rng.normal(size=3000) * 1e3).astype(np.float32)
    a = np.concatenate([stage] * delta_stages)
    a[:: 7] += 1.0  # later stages differ from stage 0 in some entries
    a[:4] = [0.0, -0.0, np.inf, 1e-40]  # zero, signed zero, inf, a denormal
    prefix = tmp_path / "table"
    jck.save_array_bf16(prefix, a, meta={"arch": "4x6"}, part_bytes=1000,
                        delta_stages=delta_stages)
    want, want_meta = jck.load_array_bf16(prefix)
    got, meta = tck.load_array_bf16(prefix)
    assert got.dtype == np.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert meta == want_meta == {"arch": "4x6"}


def test_load_array_bf16_rejects_a_foreign_format(tmp_path):
    prefix = tmp_path / "x"
    jck.save_array_bf16(prefix, np.zeros(4, np.float32))
    header = prefix.with_name("x.meta.json")
    header.write_text(header.read_text().replace("bf16_zlib_v1", "other"))
    with pytest.raises(ValueError, match="format"):
        tck.load_array_bf16(prefix)


def test_load_model_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    variables = {"table": rng.normal(size=100).astype(np.float32),
                 "nested": {"w": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    meta = {"config": {"arch": "4x6", "n_vals": 16, "thresholds": [12, 13]}}
    path = tmp_path / "m.pkl"
    jck.save_model(path, variables, meta)
    got, got_meta = tck.load_model(path)
    np.testing.assert_array_equal(got["table"], variables["table"])
    np.testing.assert_array_equal(got["nested"]["w"], variables["nested"]["w"])
    assert got_meta == meta
    jck.save_model(path, variables)
    assert tck.load_model(path)[1] == {}
