"""Carry state and weights from the JAX package into the port, through numpy.

The JAX package's ``EnvState``, cell-major boards and n-tuple tables leave
it as numpy arrays (``np.asarray``); these helpers copy them into the port's
tensors so that both packages can start from the same state, and build the
port's network from a JAX meta/config so that both evaluate the same one.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from gym2048_tpu_torch.core.fused_step import to_cell_major
from gym2048_tpu_torch.env.batched import EnvState
from gym2048_tpu_torch.models.ntuple import SmallNet
from gym2048_tpu_torch.models.ntuple_big import NTupleNetwork, make_network


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


def table_from_numpy(table: np.ndarray,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """An n-tuple table as numpy (any shape) -> flat contiguous float32
    tensor on ``device``, the layout :mod:`models.ntuple` and
    :mod:`models.ntuple_big` read."""
    return torch.from_numpy(np.ascontiguousarray(table, np.float32).reshape(-1)
                            ).to(device)


def train_state_from_numpy(d: Mapping[str, np.ndarray],
                           device: str | torch.device = "cuda",
                           generator: torch.Generator | None = None) -> dict:
    """A JAX TD train state taken out as numpy (the dict of ``TDTrainer.
    init_state`` or of a ``save_train_state`` file) -> the port's train
    state on ``device``, every array with its dtype. The JAX PRNG ``key``
    has no counterpart and is dropped (as is a saved ``generator_state``);
    ``generator``, when given, becomes the state's ``"generator"``."""
    state = {k: torch.from_numpy(np.array(v, copy=True)).to(device)
             for k, v in d.items() if k not in ("key", "generator_state")}
    if generator is not None:
        state["generator"] = generator
    return state


def network_from_config(cfg: Mapping, value_impl: str = "auto"):
    """The port's network for a JAX n-tuple config (the ``config`` of a
    table's meta, or the meta itself): a named ``arch`` of ``LAYOUTS`` or
    explicit ``tuples``, with ``n_vals`` (default 16) and ``thresholds``
    (default none), gives an :class:`NTupleNetwork`; ``arch == "small"``,
    which a config without ``arch`` means, gives the small 17 x 4-cell net
    as a :class:`~gym2048_tpu_torch.models.ntuple.SmallNet` read by
    ``value_impl`` (auto, gather, mxu or mxu_bf16; the big nets have one
    lookup and ignore it). Either one's ``value_batch(params, boards)``
    reads the table as ``params``, the small net's after its
    ``params(table)``."""
    n_vals = int(cfg.get("n_vals", 16))
    thresholds = tuple(int(t) for t in cfg.get("thresholds", ()))
    if cfg.get("tuples") is not None:
        return NTupleNetwork(cfg["tuples"], n_vals, thresholds)
    arch = cfg.get("arch", "small")
    if arch == "small":
        return SmallNet(value_impl, thresholds)
    return make_network(arch, n_vals, thresholds)
