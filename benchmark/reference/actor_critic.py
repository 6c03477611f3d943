"""The residual actor-critic CNN, written plainly as functions of named tensors.

The network of rgal/gym-2048 ``model.py`` (``ResidualBlock``,
``Game2048Model``) as PPO's actor-critic: a one-hot ``(B, 4, 4, 16)`` board
(channel c marks exponent c), a 3x3 convolution (no bias, zero padding) to
``filters`` channels, BatchNorm and ReLU; ``blocks`` residual blocks of
conv-BN-ReLU-conv-BN, the input added, ReLU; the features flattened in
(channel, row, column) order; a dense policy head to 4 logits and a dense
value head to 1. BatchNorm as flax runs it: in training the batch's mean
and biased variance normalise (eps 1e-5) and the running statistics keep
0.99 of themselves; in evaluation the running statistics normalise.

Parameters and statistics are float32. ``precision`` says how each
convolution and dense layer computes: ``"f32"`` (full float32; the caller
turns TF32 off), ``"bf16"`` (input and weight in bfloat16, float32
statistics and outputs) or ``"fp8"`` (input and weight each rounded to
float8 e4m3 under a per-tensor scale, float32 arithmetic; the backward pass
in float32).

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def leaf_shapes(filters: int, blocks: int) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape (the reference model's names)."""
    f = filters
    shapes = {"initial_conv.weight": (f, 16, 3, 3)}
    bn = lambda p: {f"{p}.weight": (f,), f"{p}.bias": (f,)}
    shapes.update(bn("initial_bn"))
    for i in range(blocks):
        shapes[f"res_blocks.{i}.conv1.weight"] = (f, f, 3, 3)
        shapes.update(bn(f"res_blocks.{i}.bn1"))
        shapes[f"res_blocks.{i}.conv2.weight"] = (f, f, 3, 3)
        shapes.update(bn(f"res_blocks.{i}.bn2"))
    shapes.update({"policy_head.weight": (4, 16 * f), "policy_head.bias": (4,),
                   "value_head.weight": (1, 16 * f), "value_head.bias": (1,)})
    return shapes


def bn_names(blocks: int) -> list[str]:
    return ["initial_bn"] + [f"res_blocks.{i}.bn{j}" for i in range(blocks) for j in (1, 2)]


def make_weights(filters: int, blocks: int, generator: torch.Generator) -> tuple[dict, dict]:
    """Weights drawn from ``generator`` in one call: every kernel a normal
    of variance 1 / fan-in, biases 0, BatchNorm scales 1; the running
    statistics at mean 0, variance 1. Returns ``(params, stats)``."""
    shapes = leaf_shapes(filters, blocks)
    kernels = [n for n in shapes if n.endswith("conv.weight") or n.endswith("conv1.weight")
               or n.endswith("conv2.weight") or n.endswith("head.weight")]
    total = sum(torch.Size(shapes[n]).numel() for n in kernels)
    flat = torch.randn(total, generator=generator, device=generator.device)
    params, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = torch.Size(shape).numel()
            fan_in = n // shape[0]
            params[name] = flat[at:at + n].reshape(shape) / fan_in ** 0.5
            at += n
        elif name.endswith("bn.weight") or ".bn1.weight" in name or ".bn2.weight" in name:
            params[name] = torch.ones(shape, device=generator.device)
        else:
            params[name] = torch.zeros(shape, device=generator.device)
    stats = {}
    for b in bn_names(blocks):
        stats[f"{b}.running_mean"] = torch.zeros(filters, device=generator.device)
        stats[f"{b}.running_var"] = torch.ones(filters, device=generator.device)
    return params, stats


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale in the forward
    pass; the gradient passes through in float32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


def _operands(x, w, precision):
    if precision == "bf16":
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    if precision == "fp8":
        return _fp8(x.float()), _fp8(w)
    return x.float(), w


def conv(x, w, precision):
    a, b = _operands(x, w, precision)
    a = a.contiguous(memory_format=torch.channels_last)  # cuDNN's NHWC kernels
    return F.conv2d(a, b, padding=1).float()


def dense(x, w, bias, precision):
    a, b = _operands(x, w, precision)
    return (a @ b.T).float() + bias


def batch_norm(x, params, stats, name, train: bool):
    """flax's BatchNorm over NCHW float32 activations; in training the
    running statistics in ``stats`` are replaced by their update."""
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
        with torch.no_grad():
            stats[f"{name}.running_mean"] = 0.99 * stats[f"{name}.running_mean"] + 0.01 * mean
            stats[f"{name}.running_var"] = 0.99 * stats[f"{name}.running_var"] + 0.01 * var
    else:
        mean, var = stats[f"{name}.running_mean"], stats[f"{name}.running_var"]
    inv = torch.rsqrt(var + 1e-5) * params[f"{name}.weight"]
    return (x - mean[:, None, None]) * inv[:, None, None] + params[f"{name}.bias"][:, None, None]


def one_hot(boards: torch.Tensor) -> torch.Tensor:
    """``(B, 4, 4)`` exponents -> ``(B, 16, 4, 4)`` float32 one-hot, NCHW."""
    return F.one_hot(boards.to(torch.int64).clamp(0, 16), 17)[..., :16].permute(0, 3, 1, 2).float()


def forward(params, stats, boards, blocks: int, train: bool, precision: str = "f32"):
    """``(logits (B, 4), value (B,))`` float32 of ``(B, 4, 4)`` boards."""
    x = one_hot(boards)
    x = F.relu(batch_norm(conv(x, params["initial_conv.weight"], precision), params, stats,
                          "initial_bn", train))
    for i in range(blocks):
        p = f"res_blocks.{i}"
        y = F.relu(batch_norm(conv(x, params[f"{p}.conv1.weight"], precision), params, stats,
                              f"{p}.bn1", train))
        y = batch_norm(conv(y, params[f"{p}.conv2.weight"], precision), params, stats,
                       f"{p}.bn2", train)
        x = F.relu(y + x)
    feats = x.flatten(1)
    logits = dense(feats, params["policy_head.weight"], params["policy_head.bias"], precision)
    value = dense(feats, params["value_head.weight"], params["value_head.bias"], precision)
    return logits, value[:, 0]
