"""BatchNorm with the residual add and the ReLU as one layer, ``y =
relu(batch_norm(x) [+ residual])``: the CUDA kernels and their plain version.

flax's BatchNorm (``gym2048_tpu/models/resnet.py``) was XLA's, not a Pallas
kernel: this layer has no TPU counterpart. The CUDA source is
``gym2048_tpu_torch/csrc/batch_norm.cu``, built at the first launch by
:mod:`gym2048_tpu_torch._build` into a library of its own; it says what
bounds the kernels (bytes) and how they keep the passes over an activation
few.

:func:`batch_norm_relu` checks its arguments, runs the plain version
(:func:`batch_norm_relu_reference`: torch's ``native_batch_norm``, the add
and ``relu``, with autograd) when ``x`` lies on the CPU, and on the card
:class:`BatchNormReLU`, whose forward and backward launch the kernels on
the current stream, raising on a build or launch failure; a CUDA tensor
never falls back to the plain version; without a gradient to take (the
rollout's policy, evaluation) it launches the forward kernels alone.
``LAUNCHES`` counts the library's calls (each forward and each backward is
one call of three kernels in train mode; an eval-mode forward one
kernel).

Both follow flax's rule: in train mode the layer normalises by the batch's
mean and biased variance, and the running statistics move by ``momentum``
towards them (the variance clipped at 0); in eval mode it normalises by the
running statistics. Activations are float32 or bfloat16 in channels-last
layout; statistics, scale, bias, the sums and the parameter gradients are
float32. The kernels round the output once (the plain version rounds the
normalised value and then the sum, where ``x`` is bfloat16).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = {"batch_norm_forward": 0, "batch_norm_backward": 0}
# rows of per-block partial sums the scratch holds; the kernels' reduction
# grids (2 blocks an SM) stay below it
MAX_BLOCKS = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CL = torch.channels_last


def batch_norm_relu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              running_mean: torch.Tensor, running_var: torch.Tensor,
                              residual: torch.Tensor | None = None, training: bool = False,
                              momentum: float = 0.01, eps: float = 1e-5) -> torch.Tensor:
    """The plain version: torch's BatchNorm, the add and ``relu``. In train
    mode the running statistics move by ``momentum`` towards the batch's mean
    and its biased variance, taken from the normalisation's own statistics
    (``1 / invstd^2 - eps``, clipped at 0 as flax clips)."""
    if training:
        out, mean, invstd = torch.native_batch_norm(x, weight, bias, None, None, True, 0.0, eps)
        with torch.no_grad():
            running_mean.lerp_(mean, momentum)
            running_var.lerp_(invstd.pow(-2).sub_(eps).clamp_min_(0.0), momentum)
    else:
        out = F.batch_norm(x, running_mean, running_var, weight, bias, False, 0.0, eps)
    return F.relu(out if residual is None else out + residual)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           running_mean: torch.Tensor, running_var: torch.Tensor,
           residual: torch.Tensor | None) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be (N, C, H, W) float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be ({c},) contiguous float32, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"residual must be {x.dtype} {tuple(x.shape)} on {x.device}, got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")


def _aligned(*tensors: torch.Tensor | None) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        from gym2048_tpu_torch import _build

        msg = _build.library("batch_norm").gym_bn_error_string(err).decode()
        raise RuntimeError(f"batch_norm {what}: CUDA launch failed with error {err} ({msg})")


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[1]


def _forward(x, weight, bias, residual, running_mean, running_var, training, momentum, eps):
    """The forward kernels -> ``(x, y, mean, invstd)``, ``x`` in channels-last
    layout; ``mean`` and ``invstd`` the batch's in train mode, None in eval
    mode (the kernel reads the running statistics)."""
    from gym2048_tpu_torch import _build

    x = x.contiguous(memory_format=_CL)
    if residual is not None:
        residual = residual.contiguous(memory_format=_CL)
    c, rows = x.shape[1], _rows(x)
    if rows == 0:
        raise ValueError("batch_norm of an empty batch")
    y = torch.empty_like(x, memory_format=_CL)
    mean = invstd = scratch = None
    if training:
        stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
        mean, invstd = stats[0], stats[1]
        scratch = torch.empty(MAX_BLOCKS * 2 * c, dtype=torch.float32, device=x.device)
    err = _build.library("batch_norm").gym_bn_forward(
        _DTYPES[x.dtype], int(_aligned(x, residual, y)), _ptr(x), _ptr(residual), _ptr(y), rows,
        c, _ptr(weight), _ptr(bias), _ptr(running_mean), _ptr(running_var), int(training),
        momentum, eps, _ptr(mean), _ptr(invstd), _ptr(scratch), MAX_BLOCKS if training else 0,
        _sms(x.device), ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _raise_on(err, "forward")
    LAUNCHES["batch_norm_forward"] += 1
    return x, y, mean, invstd


class BatchNormReLU(torch.autograd.Function):
    """``relu(batch_norm(x) [+ residual])`` on the card where a gradient is
    wanted: the forward and backward kernels of ``csrc/batch_norm.cu``.
    ``x``, ``residual`` and ``dy`` are taken in channels-last layout (copied
    into it where they are not), ``y`` and the gradients are returned in
    it."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var, training, momentum,
                eps):
        x, y, mean, invstd = _forward(x, weight, bias, residual, running_mean, running_var,
                                      training, momentum, eps)
        if not training:  # the constants the output was normalised with
            mean, invstd = running_mean.clone(), torch.rsqrt(running_var + eps)
        ctx.save_for_backward(x, y, weight, mean, invstd)
        ctx.training, ctx.has_residual = training, residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        from gym2048_tpu_torch import _build

        x, y, weight, mean, invstd = ctx.saved_tensors
        dy = dy.contiguous(memory_format=_CL)
        c, rows = x.shape[1], _rows(x)
        dx = torch.empty_like(x, memory_format=_CL)
        dres = torch.empty_like(x, memory_format=_CL) if ctx.has_residual else None
        grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
        coef = torch.empty(3 * c, dtype=torch.float32, device=x.device)
        scratch = torch.empty(MAX_BLOCKS * 2 * c, dtype=torch.float32, device=x.device)
        err = _build.library("batch_norm").gym_bn_backward(
            _DTYPES[x.dtype], int(_aligned(dy, y, x, dx, dres)), _ptr(dy), _ptr(y), _ptr(x),
            _ptr(dx), _ptr(dres), rows, c, _ptr(weight), _ptr(mean), _ptr(invstd),
            int(ctx.training), _ptr(grads[0]), _ptr(grads[1]), _ptr(coef), _ptr(scratch),
            MAX_BLOCKS, _sms(x.device),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        _raise_on(err, "backward")
        LAUNCHES["batch_norm_backward"] += 1
        return dx, grads[0], grads[1], dres, None, None, None, None, None


def batch_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    residual: torch.Tensor | None = None, training: bool = False,
                    momentum: float = 0.01, eps: float = 1e-5) -> torch.Tensor:
    """``relu(batch_norm(x) [+ residual])`` over ``(N, C, H, W)`` float32 or
    bfloat16 activations with float32 ``weight``, ``bias`` and running
    statistics of shape ``(C,)``: flax's BatchNorm (see the module
    docstring), the running statistics updated in place in train mode. On
    the CPU the plain version, on the card the kernels."""
    _check(x, weight, bias, running_mean, running_var, residual)
    if x.device.type == "cpu":
        return batch_norm_relu_reference(x, weight, bias, running_mean, running_var, residual,
                                         training, momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}; use cpu or cuda")
    with torch.cuda.device(x.device):
        return _kernels(x, weight, bias, running_mean, running_var, residual, training, momentum,
                        eps)


def _kernels(x, weight, bias, running_mean, running_var, residual, training, momentum, eps):
    """The layer through the kernels: :class:`BatchNormReLU` where a gradient
    is wanted, else the forward kernels alone."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, residual)):
        return BatchNormReLU.apply(x, weight, bias, residual, running_mean, running_var, training,
                                   momentum, eps)
    return _forward(x, weight, bias, residual, running_mean, running_var, training, momentum,
                    eps)[1]
