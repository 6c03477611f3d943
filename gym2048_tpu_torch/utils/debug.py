"""Determinism and numerical-safety utilities (counterpart of
``gym2048_tpu/utils/debug.py``).

* :func:`validate_boards` — invariant checks on env boards (exponent
  range, tile-count sanity), as a per-board mask; with ``enabled`` an
  invalid batch raises on the host after one sync (a device-side assert
  would end the CUDA context);
* :func:`assert_finite_tree` — NaN/Inf guard over nested state (dicts,
  lists, tuples, dataclasses such as the PPO ``TrainState``, modules and
  optimisers through their state dicts, tensors and arrays), for use at
  iteration boundaries in trainers;
* :func:`trajectory_fingerprint` — order-independent digest of a rollout
  for cross-run / cross-topology determinism checks (the same seed in one
  process and over two ranks must give the same fingerprint), the same
  integer as the JAX package's for the same arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def validate_boards(board: torch.Tensor, *, enabled: bool = True) -> torch.Tensor:
    """Per-board validity mask of ``(..., 4, 4)`` exponent boards: every
    exponent in [0, 16] and between 1 and 16 tiles. With ``enabled`` an
    invalid board raises ``ValueError("invalid board state detected")``
    (one host sync)."""
    e = torch.as_tensor(board).to(torch.int32)
    in_range = ((e >= 0) & (e <= 16)).all(-1).all(-1)
    n_tiles = (e > 0).sum((-1, -2))
    ok = in_range & (n_tiles >= 1) & (n_tiles <= 16)
    if enabled and not bool(ok.all()):
        raise ValueError("invalid board state detected")
    return ok


def _leaves(tree, path: str = ""):
    """``(key path, leaf)`` of every array-like leaf, the path in JAX's
    ``keystr`` style (``['key']``, ``[0]``, ``.field``)."""
    if isinstance(tree, (torch.Tensor, np.ndarray, float, np.floating)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif hasattr(tree, "state_dict") and callable(tree.state_dict):
        yield from _leaves(tree.state_dict(), path)


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` with a
    NaN or Inf (host-side)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        elif isinstance(leaf, np.ndarray):
            bad = np.issubdtype(leaf.dtype, np.floating) and not np.isfinite(leaf).all()
        else:
            bad = not math.isfinite(float(leaf))
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def trajectory_fingerprint(boards, rewards, dones) -> int:
    """Deterministic digest of a rollout, independent of the order of its
    entries (so of how the env batch was split over ranks); tensors or
    arrays."""
    b = _numpy(boards).astype(np.int64)
    r = _numpy(rewards).astype(np.float64)
    d = _numpy(dones).astype(np.int64)
    return int((b.sum() * 1000003 + np.round(r.sum() * 16).astype(np.int64)
                + d.sum() * 7919) % (1 << 62))
