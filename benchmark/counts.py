"""Work counts and the card's peaks, for the roofline and ``mfu`` shares.

The counts are of the work the algorithm needs at the cell's shapes, the
same whatever implements it: each input byte read once and each output
byte written once, and for a table each distinct 32-byte sector that the
unit's lookups or updates touch, once. A dense pass over a whole table and
a sparse one over the touched entries therefore count the same work.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the card's full 700 W power limit.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
SECTOR_BYTES = 32
F32_PER_SECTOR = SECTOR_BYTES // 4


def distinct_sectors(idx: torch.Tensor) -> int:
    """Distinct 32-byte sectors of a float32 table that the indices read."""
    return int(torch.unique(idx.reshape(-1).to(torch.int64) // F32_PER_SECTOR).numel())


def gather_bytes(n_indices: int, sectors: int) -> int:
    """Least bytes of one lookup of ``n_indices`` int32 indices into a
    float32 table: the indices read and the values written once (8 bytes
    an index), and each distinct table sector read once."""
    return 8 * n_indices + SECTOR_BYTES * sectors


def bytes_time_s(nbytes: float) -> float:
    """Least seconds to move ``nbytes`` through the card's memory."""
    return nbytes / HBM_BYTES_PER_S


def cnn_forward_flops(filters: int, blocks: int) -> float:
    """FLOPs (2 a multiply-add) of one actor-critic forward on a 4 x 4
    board: the 3x3 convolutions (16 -> filters, then two a block, filters
    -> filters) at 16 positions and the two dense heads over the
    ``filters * 16`` features (5 outputs); BatchNorm, ReLU and the one-hot
    input are left out."""
    macs = 16 * 9 * 16 * filters + blocks * 2 * 16 * 9 * filters * filters + 16 * filters * 5
    return 2.0 * macs


def cnn_first_conv_flops(filters: int) -> float:
    """FLOPs of the first convolution on one board (its input gradient is
    never needed: the input is data)."""
    return 2.0 * 16 * 9 * 16 * filters


def ppo_iteration_flops(n_envs: int, n_steps: int, n_epochs: int, filters: int,
                        blocks: int) -> float:
    """FLOPs of one PPO iteration: ``n_steps + 1`` forwards of ``n_envs``
    boards in the rollout, and per epoch a forward and a backward of every
    sample; a backward is two forwards' worth (weight and input gradients)
    less the first convolution's input gradient."""
    fwd = cnn_forward_flops(filters, blocks)
    update = 3 * fwd - cnn_first_conv_flops(filters)
    return fwd * (n_steps + 1) * n_envs + update * n_epochs * n_steps * n_envs
