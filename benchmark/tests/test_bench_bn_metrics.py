"""The readers of the BatchNorm layer's device time (``bn_device_ms.ppo``,
``bn_fused_share.ppo``): listed for the PPO cell in the model layer, and
their arithmetic on the device seconds of a trace: torch's BatchNorm kernels
alone (the fused share 0), the fused kernels alone (100), both, and none
(None)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, tracing
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAMES = ("bn_device_ms.ppo", "bn_fused_share.ppo")

# the kernels of one traced iteration of the cell with torch's BatchNorm and
# with the fused layer, by their full names, in device seconds (H100)
TORCH_BN = {
    "void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, "
    "c10::BFloat16, float, 4>(...)": 0.0765,
    "void at::native::batch_norm_transform_input_channels_last_kernel<c10::BFloat16, float, "
    "float, int>(...)": 0.0532,
    "void at::native::batch_norm_backward_reduce_channels_last_kernel<4, c10::BFloat16, float, "
    "float>(...)": 0.0493,
    "void at::native::batch_norm_backward_elemt_channels_last_kernel<4, c10::BFloat16, float, "
    "float>(...)": 0.0556,
}
FUSED_BN = {
    "void (anonymous namespace)::gym_bn_stats_kernel<(anonymous namespace)::Bf16, 8, 256>(...)":
        0.030,
    "void (anonymous namespace)::gym_bn_finalize_stats_kernel<(anonymous namespace)::Bf16, "
    "1024>(...)": 0.004,
    "void (anonymous namespace)::gym_bn_apply_kernel<(anonymous namespace)::Bf16, 8, 256>(...)":
        0.040,
    "void (anonymous namespace)::gym_bn_backward_reduce_kernel<(anonymous namespace)::Bf16, 8, "
    "256>(...)": 0.035,
    "void (anonymous namespace)::gym_bn_finalize_backward_kernel<1024>(...)": 0.004,
    "void (anonymous namespace)::gym_bn_backward_elemt_kernel<(anonymous namespace)::Bf16, 8, "
    "256>(...)": 0.047,
}
OTHER = {
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": 0.0762,
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctorOnSelf_add"
    "<c10::BFloat16>>(...)": 0.0381,
}


def context(op_s: dict, units: int = 1) -> tracing.Context:
    return tracing.Context(entry=None, units=units, steps=128.0, window_s=1.0, busy_s=0.9,
                           ops=len(op_s), op_s=op_s, span_device_s={}, span_host_s={}, stash={},
                           breakdown={})


def test_listed_for_the_ppo_cell_in_the_model_layer():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NAMES:
        m = by_name[name]
        assert m["workloads"] == ["ppo-prod-bf16"] and m["moves"] == "ppo_steps_per_s"
        assert m["layer"] == "model (models/resnet.py)" == by_name["step_mfu.ppo"]["layer"]
        assert m["source"] == "device_trace"
    assert by_name["bn_device_ms.ppo"]["unit"] == "ms/iteration"
    assert by_name["bn_fused_share.ppo"]["unit"] == "%"


@pytest.mark.parametrize("op_s, units, device_ms, share", [
    ({**TORCH_BN, **OTHER}, 1, 234.6, 0.0),                    # the parent's iteration
    ({**FUSED_BN, **OTHER}, 1, 160.0, 100.0),                  # the fused layer's
    ({**TORCH_BN, **FUSED_BN, **OTHER}, 2, 197.3, 160.0 / 3.946),  # both, over two iterations
    (OTHER, 1, None, None),                                    # no BatchNorm kernel
    ({}, 1, None, None),                                       # no device trace (the CPU)
])
def test_arithmetic_on_device_seconds(op_s, units, device_ms, share):
    ms, fused = (harness.load_metric(n)(context(op_s, units)) for n in NAMES)
    assert ms == (pytest.approx(device_ms) if device_ms is not None else None)
    assert fused == (pytest.approx(share) if share is not None else None)
