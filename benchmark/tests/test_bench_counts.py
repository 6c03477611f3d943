"""The work counts against hand counts."""

from __future__ import annotations

import pytest
import torch

from benchmark import counts


def test_cnn_forward_matches_the_hand_count_at_16384_boards():
    # 16 positions x (16 -> 64 first conv: 9 x 16 x 64 MACs, 8 convs of
    # 9 x 64 x 64) + two heads over 1024 features (5 outputs); 2 FLOPs a MAC
    per_board = 2 * (16 * 9 * 16 * 64 + 8 * 16 * 9 * 64 * 64 + 1024 * 5)
    assert counts.cnn_forward_flops(64, 4) == per_board == 9_742_336
    assert counts.cnn_forward_flops(64, 4) * 16384 == pytest.approx(159.6e9, rel=1e-3)


def test_ppo_iteration_counts_rollout_forwards_and_update_passes():
    fwd = counts.cnn_forward_flops(64, 4)
    first = 2 * 16 * 9 * 16 * 64
    want = fwd * 129 * 4096 + (3 * fwd - first) * 4 * 128 * 4096
    assert counts.ppo_iteration_flops(4096, 128, 4, 64, 4) == want
    # PR 11 counted 66.44 TFLOP: the first convolution's input gradient as well
    assert 65.8e12 < want < 66.44e12


def test_gather_bytes_and_distinct_sectors():
    idx = torch.tensor([0, 1, 7, 8, 15, 16, 1000, 1001], dtype=torch.int32)
    assert counts.distinct_sectors(idx) == 4  # sectors 0, 1, 2, 125
    assert counts.gather_bytes(8, 4) == 8 * 8 + 32 * 4
    assert counts.bytes_time_s(3.35e12) == pytest.approx(1.0)


def test_peaks_are_the_data_sheet_dense_rates():
    assert counts.PEAK_FLOPS == {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12
