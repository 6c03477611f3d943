"""Exact f32 table lookup ``table[idx]``: the CUDA kernel and its plain version.

Counterpart of ``gym2048_tpu/models/pallas_table.py`` (``gather_values``,
a Pallas TPU kernel). The CUDA source is
``gym2048_tpu_torch/csrc/table_gather.cu``, compiled at the first launch
by :mod:`gym2048_tpu_torch._build` into a library of its own.

The TPU kernel's ``chunk`` and ``n_sem`` (a ring of row DMAs and a
one-hot lane select, because the TPU's scalar core cannot read single
words of HBM) have no meaning on the GPU and are not carried, and neither
are its shape rules: here N and the table size S may be anything. The
kernel takes one 16-byte group of four indices per thread, and a scalar
head and tail in the same launch align the stream: only index and output
pointers at different offsets modulo 16 bytes take its
one-index-per-thread kernel.

:func:`gather_values` checks its arguments, runs the plain version
(:func:`gather_values_reference`, ``torch.take``) when the tensors lie on
the CPU, and otherwise launches the kernel on the current stream, raising
on a build or launch failure; a CUDA tensor never falls back to the plain
version. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"gather_values": 0}


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 1 or table.dtype != torch.float32:
        raise ValueError(f"table must be flat float32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (N,) int32, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")


def gather_values_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.take`` on int64 indices."""
    return torch.take(table, idx.to(torch.int64))


def gather_values(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: flat ``(S,)`` float32 table, ``(N,)`` int32 indices
    in ``[0, S)``; returns ``(N,)`` float32, equal bit for bit.

    On CUDA tensors the kernel does not check the indices (the plain
    version on the CPU raises on one out of range)."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_values_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {table.device}; use cpu or cuda")
    from gym2048_tpu_torch import _build

    with torch.cuda.device(table.device):
        idx = idx.contiguous()
        out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
        if idx.numel() == 0:
            return out
        lib = _build.library("table_gather")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gym_gather_values(ctypes.c_void_p(table.data_ptr()),
                                    ctypes.c_void_p(idx.data_ptr()),
                                    ctypes.c_void_p(out.data_ptr()),
                                    idx.numel(), ctypes.c_void_p(stream))
        if err != 0:
            msg = lib.gym_gather_error_string(err).decode()
            raise RuntimeError(f"gather_values: CUDA launch failed with error "
                               f"{err} ({msg})")
        LAUNCHES["gather_values"] += 1
    return out
