"""The ``(data, model)`` mesh and the data-parallel layout, over
``torch.distributed`` (counterpart of ``gym2048_tpu/parallel/mesh.py``).

Pure data parallelism, as in the JAX package: each rank holds its block of
the env batch (and of every rollout and minibatch tensor), and the
parameters, optimiser state, tables and generators are replicated, every
rank keeping a full copy. The ``model`` axis exists so that the layout
generalises, and stays size 1.

Where JAX places arrays with shardings and lets XLA insert the collectives,
here every rank holds plain local tensors, and the learners issue the
collectives themselves (``all_reduce`` only: gloo, the backend of CPU
tensors and of several ranks sharing one card, supports no other collective
on CUDA tensors besides ``broadcast``). DTensor is not used: the lookup
kernel's wrapper passes raw pointers of local tensors to its library. The
placement functions therefore take a tensor or a state and return this
rank's part of it:

* :func:`shard_batch` — this rank's block of a batch-led tensor;
* :func:`replicate` — the value itself: a replicated value must be the same
  on every rank, as JAX's ``device_put`` of a process-local array requires
  (build it from the same seed, or load the same file, on every rank);
* :func:`shard_env_state` / :func:`shard_train_state` — an ``EnvState``'s
  fields (all batch-led) sharded; a PPO ``TrainState``'s env state sharded
  and everything else replicated;
* :func:`gather_batch` — the inverse of :func:`shard_batch`, for a rank
  that writes a checkpoint: the blocks of every rank, collected with an
  ``all_reduce`` into zeros over integer views of the bits (exact, and
  supported by gloo on CUDA tensors).

Multi-process runs start under ``torchrun`` (or with ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set by hand): call
:func:`init_distributed` first, then :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
# init_process_group arguments that name a coordinator
_COORDINATOR_KWARGS = ("init_method", "store", "world_size", "rank")


def init_distributed(**kwargs) -> None:
    """Initialise the default process group over ``env://`` (the variables
    ``torchrun`` sets); ``kwargs`` go to ``torch.distributed.init_process_group``.

    The backend is :func:`default_backend` of the card when CUDA is
    available and gloo otherwise; with NCCL each rank takes card
    ``LOCAL_RANK`` modulo the cards there are. A failure is swallowed, with
    a warning, only when no coordinator is configured anywhere
    (``MASTER_ADDR`` unset and no ``init_method``, ``store``, ``world_size``
    or ``rank`` given): a genuine single-process run. Otherwise it
    re-raises, so a job meant to span ranks never trains alone."""
    if dist.is_initialized():
        return
    kwargs = dict(kwargs)
    backend = kwargs.pop("backend", None) or default_backend(
        "cuda" if torch.cuda.is_available() else "cpu")
    configured = bool(os.environ.get("MASTER_ADDR")) or any(
        k in kwargs for k in _COORDINATOR_KWARGS)
    if "store" not in kwargs:
        kwargs.setdefault("init_method", "env://")
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(backend=backend, **kwargs)
    except (ValueError, RuntimeError) as e:
        if configured:
            raise
        warnings.warn(f"init_distributed: no coordinator configured, continuing "
                      f"single-process ({e})")


def default_backend(device: str | torch.device) -> str:
    """The process group's backend for ranks on ``device``: NCCL on cards
    when each local rank has a card of its own, else gloo (the CPU, or
    several ranks sharing a card, which NCCL refuses)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """``device`` for this rank: ``cuda`` without an index becomes card
    ``LOCAL_RANK`` modulo the cards there are (several ranks share a card
    when there are fewer cards than ranks; with no card it raises); any
    other device is itself."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass the CPU as the device to run there")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(devices: Sequence[int] | None = None, model_parallelism: int = 1) -> DeviceMesh:
    """The ``(data, model)`` mesh over the given global ranks (default: every
    rank of the default group), ``model_parallelism`` ranks along ``model``.
    With no process group initialised it is a one-rank mesh (rank 0) that
    issues no collective."""
    initialized = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = range(world_size())
    ranks = [int(d) for d in devices]
    if len(ranks) % model_parallelism:
        raise ValueError(f"{len(ranks)} ranks do not divide into model_parallelism "
                         f"{model_parallelism}")
    grid = torch.tensor(ranks, dtype=torch.int).reshape(-1, model_parallelism)
    names = (DATA_AXIS, MODEL_AXIS)
    if not initialized:
        if ranks != [0]:
            raise ValueError(f"ranks {ranks} without a process group: call init_distributed")
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        return DeviceMesh(kind, grid, mesh_dim_names=names, _init_backend=False, _rank=0)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, grid, mesh_dim_names=names)


def data_size(mesh: DeviceMesh | None) -> int:
    """Ranks along the mesh's ``data`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(0)


def data_rank(mesh: DeviceMesh | None) -> int:
    """This rank's index along the mesh's ``data`` axis (0 without a mesh)."""
    if data_size(mesh) == 1:
        return 0
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
    return coordinate[0]


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh: DeviceMesh | None, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place over the mesh's ``data`` axis (``"sum"`` or
    ``"max"``) and returned; nothing is issued on a one-rank axis."""
    if data_size(mesh) > 1:
        dist.all_reduce(x, op=_OPS[op], group=mesh.get_group(DATA_AXIS))
    return x


def shard_batch(x: torch.Tensor, mesh: DeviceMesh | None, axis: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis`` (a contiguous copy): rank
    r of n takes entries ``[r * len / n, (r + 1) * len / n)``. ``x`` itself
    on a one-rank axis."""
    n = data_size(mesh)
    if n == 1:
        return x
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of length {size} does not split over {n} ranks")
    k = size // n
    return x.narrow(axis, data_rank(mesh) * k, k).clone()


def _int_view(x: torch.Tensor) -> torch.Tensor:
    """The bits of ``x`` as an integer tensor that gloo reduces."""
    size = x.element_size()
    if size == 2:
        return x.view(torch.int16).to(torch.int32)
    return x.view({1: torch.uint8 if x.dtype == torch.bool else x.dtype,
                   4: torch.int32, 8: torch.int64}[size])


def gather_batch(x: torch.Tensor, mesh: DeviceMesh | None, axis: int = 0) -> torch.Tensor:
    """The inverse of :func:`shard_batch`: the whole tensor, every rank's
    block in place, on every rank (a collective). Exact for every dtype: the
    blocks meet zeros in an integer sum of their bits."""
    n = data_size(mesh)
    if n == 1:
        return x
    shape = list(x.shape)
    k = shape[axis]
    shape[axis] = k * n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(axis, data_rank(mesh) * k, k).copy_(x)
    bits = all_reduce(_int_view(out), mesh)
    if x.element_size() == 2:
        return bits.to(torch.int16).view(x.dtype)
    return bits.view(x.dtype)


def replicate(x: Any, mesh: DeviceMesh | None) -> Any:
    """A replicated value: ``x`` itself, which must be the same on every
    rank (see the module docstring)."""
    return x


def shard_env_state(env_state: Any, mesh: DeviceMesh | None) -> Any:
    """An ``EnvState`` with every field (each batch-led) replaced by this
    rank's block."""
    return dataclasses.replace(env_state, **{
        f.name: shard_batch(getattr(env_state, f.name), mesh)
        for f in dataclasses.fields(env_state)})


def gather_env_state(env_state: Any, mesh: DeviceMesh | None) -> Any:
    """The inverse of :func:`shard_env_state` (a collective)."""
    return dataclasses.replace(env_state, **{
        f.name: gather_batch(getattr(env_state, f.name), mesh)
        for f in dataclasses.fields(env_state)})


def shard_train_state(train_state: Any, mesh: DeviceMesh | None) -> Any:
    """A PPO ``TrainState`` for this rank: the env state sharded over
    ``data``, everything else (model, optimiser, generator, ``update_idx``)
    replicated."""
    return dataclasses.replace(train_state,
                               env_state=shard_env_state(train_state.env_state, mesh))
