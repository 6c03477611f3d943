"""Residual CNN policy models, in PyTorch (counterpart of
``gym2048_tpu/models/resnet.py``).

* :class:`Game2048Model`: the supervised / BC policy: initial
  conv-BN-ReLU, N residual blocks, then a policy head (1x1 conv to 2
  channels, BN, dense layer to 4 logits; ``forward`` returns their
  softmax).
* :class:`ActorCritic`: the PPO network: the same residual trunk
  flattened to ``filters * 16`` features, with dense policy-logit and
  value heads.

Layout. The input is the one-hot of :func:`boards_to_model_input`,
``(B, 4, 4, 16)`` channels last, as in the JAX package; the models permute
it once to torch's NCHW. Features are flattened in (c, h, w) order, the
reference torch models' order, and the parameters carry the reference's
names (``initial_conv``, ``initial_bn``, ``res_blocks.N.conv1/bn1/conv2/bn2``,
``policy_conv``, ``policy_bn``, ``policy_fc``), so a reference
``Game2048Model.state_dict()`` loads with ``load_state_dict`` alone. The
JAX dense kernels read the (h, w, c) flatten; :mod:`gym2048_tpu_torch.interop`
permutes them.

BatchNorm follows flax, not torch: the running statistics keep 0.99 of
themselves per update (torch's ``momentum=0.01``), eps is 1e-5, and the
running variance takes the batch's biased variance (torch's own
``BatchNorm2d`` takes the unbiased one). Every BatchNorm of the models is
followed by a ReLU, and the second of a residual block by the skip
connection's add before it, so :class:`BatchNorm` is the whole layer, ``y =
relu(batch_norm(x) [+ residual])``, in :mod:`.batch_norm`: on the card its
own CUDA kernels (statistics, apply, backward reduce and elementwise; the
running statistics updated by their finalize kernel), which round the
output once and merge the batch's variance in float64; on the CPU the plain
version, torch's ``native_batch_norm`` (whose batch statistics, the mean
and the inverse deviation, also update the running statistics), the add and
``relu``, where flax computes the variance as ``E[x^2] - E[x]^2``
(``use_fast_variance``): the same to roundoff.
Statistics are always float32. Inside :func:`sync_batch_norm` (data-parallel
PPO), a train-mode BatchNorm takes its batch statistics over the ranks of a
process group, through an autograd-aware ``all_reduce`` of each channel's
sum and sum of squares, and computes flax's ``E[x^2] - E[x]^2`` variance;
torch's ``nn.SyncBatchNorm`` does not serve: it refuses CPU tensors and
updates the running variance with the unbiased variance.

Train and eval follow ``module.train()`` / ``module.eval()``, where flax
passes ``train=``; a model is built in eval mode, as the JAX modules'
``train=False`` default. ``dtype`` is the compute dtype: with
``torch.bfloat16`` the parameters stay float32, each convolution and dense
layer casts its input and weight to bfloat16 inside the forward (not
``torch.autocast``), BatchNorm takes bfloat16 activations with float32
statistics, scale and bias, accumulates in float32 and returns bfloat16,
and the outputs are float32, as the JAX ``dtype=`` field does.
Initialisation is flax's: LeCun normal (a normal truncated at two standard
deviations, rescaled to variance 1 / fan_in) for the kernels, zero biases,
BatchNorm scale 1 and bias 0, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from gym2048_tpu_torch.models.batch_norm import batch_norm_relu

# flax's variance_scaling(1.0, "fan_in", "truncated_normal"): the standard
# deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def boards_to_model_input(board: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exponent boards ``(..., 4, 4)`` -> one-hot ``(..., 4, 4, 16)``
    channels last: channel c marks exponent c (exponents from 16 up encode
    to all zeros, as ``jax.nn.one_hot``). Stored channels last, the models'
    NCHW view of it is in torch's ``channels_last`` memory format, which
    every layer keeps: on the card cuDNN then runs its NHWC convolution and
    BatchNorm kernels, where a contiguous NCHW input (``ops.obs.env_stack``)
    made a PPO iteration half as fast."""
    e = board.to(torch.int32)[..., None]
    channels = torch.arange(16, dtype=torch.int32, device=board.device)
    return (e == channels).to(dtype)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


# (process group, ranks in it) of the BatchNorm statistics, or None: one rank
_SYNC = None


@contextlib.contextmanager
def sync_batch_norm(group, world: int):
    """Train-mode BatchNorm inside the block takes its batch statistics over
    the ``world`` ranks of ``group`` (each rank holding an equal share of
    the batch); the running statistics take the global batch's."""
    global _SYNC
    prev, _SYNC = _SYNC, (group, world)
    try:
        yield
    finally:
        _SYNC = prev


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` over NCHW activations with the ReLU after it
    and a residual added before that (see the module docstring), with
    torch's parameter and buffer names."""

    def __init__(self, channels: int, device=None):
        super().__init__(channels, eps=1e-5, momentum=0.01, device=device)

    def _synced(self, x: torch.Tensor, group, world: int) -> torch.Tensor:
        """Train mode over the ranks of ``group`` (see :func:`sync_batch_norm`)."""
        import warnings

        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        n = xf.numel() // xf.shape[1] * world
        with warnings.catch_warnings():  # newer torch marks it deprecated
            warnings.simplefilter("ignore", FutureWarning)
            sums = all_reduce(torch.stack([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))]),
                              group=group)
        mean = sums[0] / n
        var = (sums[1] / n - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, 0.01)
            self.running_var.lerp_(var, 0.01)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        """``relu(batch_norm(x) [+ residual])``."""
        if self.training and _SYNC is not None:
            y = self._synced(x, *_SYNC)
            return F.relu(y if residual is None else y + residual)
        return batch_norm_relu(x, self.weight, self.bias, self.running_mean, self.running_var,
                               residual, self.training, self.momentum, self.eps)


class Conv(nn.Conv2d):
    """A bias-free ``SAME``-padded convolution computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(cin, cout, kernel, padding=kernel // 2, bias=False, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, padding=self.padding)

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)


class Dense(nn.Linear):
    """A dense layer computed in ``dtype``."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(fin, fout, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.in_features, generator)
        with torch.no_grad():
            self.bias.zero_()


class ResidualBlock(nn.Module):
    """conv3x3-BN-ReLU x2 with a skip connection."""

    def __init__(self, filters: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv(filters, filters, 3, dtype, device)
        self.bn1 = BatchNorm(filters, device)
        self.conv2 = Conv(filters, filters, 3, dtype, device)
        self.bn2 = BatchNorm(filters, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.conv2(self.bn1(self.conv1(x))), x)


class _Trunk(nn.Module):
    """Initial conv-BN-ReLU + N residual blocks, shared by both models (a
    base class, so that its parameters keep the reference's top-level
    names)."""

    def __init__(self, filters: int, residual_blocks: int, dtype: torch.dtype, device):
        super().__init__()
        self.filters = filters
        self.residual_blocks = residual_blocks
        self.dtype = dtype
        self.initial_conv = Conv(16, filters, 3, dtype, device)
        self.initial_bn = BatchNorm(filters, device)
        self.res_blocks = nn.ModuleList(ResidualBlock(filters, dtype, device)
                                        for _ in range(residual_blocks))

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, 4, 4, 16)`` one-hot -> ``(B, filters, 4, 4)`` features."""
        x = x.permute(0, 3, 1, 2)
        x = self.initial_bn(self.initial_conv(x))
        for block in self.res_blocks:
            x = block(x)
        return x

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initialisation of every layer, drawn from ``generator``
        (default: a fresh one seeded 0 on the parameters' device), in the
        order the layers are registered; BatchNorm to scale 1, bias 0,
        mean 0, variance 1."""
        if generator is None:
            generator = torch.Generator(device=self.initial_conv.weight.device).manual_seed(0)
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                m.init_weights(generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()


class Game2048Model(_Trunk):
    """Residual CNN policy: one-hot boards ``(B, 4, 4, 16)`` -> action
    probabilities ``(B, 4)``; :meth:`logits` gives the pre-softmax logits.
    Arguments mirror the reference ``build_model``; on the card unless
    ``device`` says otherwise."""

    def __init__(self, board_size: int = 4, board_layers: int = 16, outputs: int = 4,
                 filters: int = 64, residual_blocks: int = 4,
                 dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        if (board_size, board_layers) != (4, 16):
            raise ValueError("the model reads 4 x 4 boards of 16 one-hot layers")
        super().__init__(filters, residual_blocks, dtype, device)
        self.outputs = outputs
        self.policy_conv = Conv(filters, 2, 1, dtype, device)
        self.policy_bn = BatchNorm(2, device)
        self.policy_fc = Dense(2 * 16, outputs, dtype, device)
        self.init_weights(generator)
        self.eval()

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-softmax logits ``(B, outputs)`` float32."""
        x = self.policy_bn(self.policy_conv(self.trunk(x)))
        return self.policy_fc(x.flatten(1)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(x), dim=-1)


class ActorCritic(_Trunk):
    """PPO network: residual trunk + dense policy and value heads over the
    flattened ``filters * 16`` features. ``forward`` returns
    ``(policy_logits (B, 4) f32, value (B,) f32)``."""

    def __init__(self, filters: int = 64, residual_blocks: int = 4,
                 dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__(filters, residual_blocks, dtype, device)
        self.policy_head = Dense(filters * 16, 4, dtype, device)
        self.value_head = Dense(filters * 16, 1, dtype, device)
        self.init_weights(generator)
        self.eval()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        features = self.trunk(x).flatten(1)
        logits = self.policy_head(features)
        value = self.value_head(features)
        return logits.float(), value.float()[..., 0]


def build_model(board_size: int = 4, board_layers: int = 16, outputs: int = 4,
                filters: int = 64, residual_blocks: int = 4,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> Game2048Model:
    """Factory mirroring the reference ``build_model`` signature."""
    return Game2048Model(board_size, board_layers, outputs, filters, residual_blocks,
                         dtype, device)
