"""Observation encoders of exponent boards (counterpart of
``gym2048_tpu/ops/obs.py``).

The reference has two one-hot encodings, and both are kept:

* :func:`env_stack`, the env observation: ``(..., 16, 4, 4)`` channels
  first; channel 0 marks empty cells, channels 1..15 the tiles 2^1..2^15.
  A 65536 tile (exponent 16) encodes to all-zero channels.
* :func:`dataset_stack`, the training-data stacking: ``(..., 4, 4, 16)``
  channels last; channels mark 2^1..2^16, and there is no empty channel.

On exponent boards each is one integer comparison against a range.
"""

from __future__ import annotations

import torch


def env_stack(board: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exponent board ``(..., 4, 4)`` -> ``(..., 16, 4, 4)`` env observation:
    channel c is 1 where the exponent equals c."""
    e = board.to(torch.int32)[..., None, :, :]
    channels = torch.arange(16, dtype=torch.int32, device=board.device)[:, None, None]
    return (e == channels).to(dtype)


def dataset_stack(board: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exponent board ``(..., 4, 4)`` -> ``(..., 4, 4, 16)`` dataset stacking:
    channel j is 1 where the exponent equals j + 1; empty cells encode to
    all-zero."""
    e = board.to(torch.int32)[..., None]
    channels = torch.arange(1, 17, dtype=torch.int32, device=board.device)
    return (e == channels).to(dtype)


def unstack_env(obs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`env_stack`: ``(..., 16, 4, 4)`` -> int8 exponent
    board, the sum of channel index x channel (the argmax channel on
    one-hot input)."""
    channels = torch.arange(16, dtype=torch.int32, device=obs.device)[:, None, None]
    return (obs.to(torch.int32) * channels).sum(-3, dtype=torch.int32).to(torch.int8)


def dataset_to_env(stacked: torch.Tensor) -> torch.Tensor:
    """Dataset stacking ``(..., 4, 4, 16)`` -> env layout ``(..., 16, 4, 4)``
    through the exponent board (the two encodings differ in channel
    meaning), in the input's dtype."""
    channels = torch.arange(1, 17, dtype=torch.int32, device=stacked.device)
    exps = (stacked.to(torch.int32) * channels).sum(-1, dtype=torch.int32)
    return env_stack(exps, dtype=stacked.dtype)
