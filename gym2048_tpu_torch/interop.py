"""Carry state from the JAX package into the port, through numpy.

The JAX package's ``EnvState`` and cell-major boards leave it as numpy
arrays (``np.asarray``); these helpers copy them into the port's tensors so
that both packages can start from the same state.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from gym2048_tpu_torch.core.fused_step import to_cell_major
from gym2048_tpu_torch.env.batched import EnvState


def env_state_from_numpy(d: Mapping[str, np.ndarray],
                         device: str | torch.device = "cuda") -> EnvState:
    """A JAX ``EnvState`` taken out as numpy (``board``, ``score``, ``done``,
    ``step_count``) -> the port's :class:`EnvState` on ``device``. Other
    entries, such as the JAX PRNG ``key``, have no counterpart and are
    dropped."""
    return EnvState(
        board=torch.tensor(np.asarray(d["board"], np.int8), device=device),
        score=torch.tensor(np.asarray(d["score"], np.float32), device=device),
        done=torch.tensor(np.asarray(d["done"], bool), device=device),
        step_count=torch.tensor(np.asarray(d["step_count"], np.int32),
                                   device=device),
    )


def cell_major_from_numpy(boards: np.ndarray,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """``(B, 4, 4)`` exponent boards as numpy -> ``[16, B]`` int32 cell-major
    tensor on ``device``, the layout of the fused kernels."""
    return to_cell_major(torch.tensor(np.asarray(boards), device=device))
