"""Checkpoints, model files and table artifacts (counterpart of
``gym2048_tpu/utils/checkpoint.py``).

* :class:`Checkpointer`: step-indexed checkpoints of a whole training state,
  ``<root>/<step>/state.pt``, written with ``torch.save`` as a host copy
  (every tensor on the CPU), restored into a state that already exists on
  its own device. The JAX package's Orbax directories are not read: Orbax
  is a JAX library.
* :func:`save_model` and :func:`load_model`: one-shot model files, a pickle
  of numpy arrays in the JAX package's layout, which both packages read.
* :func:`load_array_bf16`: the ``bf16_zlib_v1`` artifacts of
  ``save_array_bf16``, such as the committed n-tuple tables. bf16 is the
  top half of an f32, so the artifact is decoded without ``ml_dtypes``:
  each 16-bit word shifted into the high half of a 32-bit word is the f32
  it stands for.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _to_host(tree: Any) -> Any:
    """Every leaf of nested dicts, lists and tuples as a numpy array (a
    tensor is copied to the host first)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


_STATE_FILE = "state.pt"


def _state_to_host(obj: Any) -> Any:
    """A host copy of a training state, as nested dicts, lists and CPU
    tensors that ``torch.load(weights_only=True)`` reads: a module or an
    object with ``state_dict()`` (an optimiser) as its state dict, a
    ``torch.Generator`` as its state and device type, a dataclass as the
    dict of its fields, a numpy array as a tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj, copy=True))
    if isinstance(obj, torch.Generator):
        return {"generator_state": obj.get_state(), "device_type": obj.device.type}
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        return {"state_dict": _state_to_host(obj.state_dict())}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _state_to_host(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _state_to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_state_to_host(v) for v in obj)
    return obj


def _restore_into(like: Any, saved: Any, where: str = "state") -> Any:
    """``saved`` (a :func:`_state_to_host` tree) in the structure of
    ``like``: tensors on ``like``'s devices and dtypes, modules, optimisers
    and generators loaded in place, dataclasses rebuilt with
    ``dataclasses.replace``. A generator's stream cannot carry across
    device types (the CPU's Mersenne Twister, CUDA's Philox): a state saved
    from the other type seeds ``like`` from the saved state's SHA-256, so
    the continuation is deterministic but not the saving device's."""
    if isinstance(like, torch.Tensor):
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return saved.numpy().astype(like.dtype)
    if isinstance(like, torch.Generator):
        state = saved["generator_state"]
        if saved["device_type"] == like.device.type:
            like.set_state(state)
        else:
            digest = hashlib.sha256(state.numpy().tobytes()).digest()
            like.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        return like
    if hasattr(like, "load_state_dict") and callable(like.load_state_dict):
        like.load_state_dict(saved["state_dict"])
        return like
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = [f.name for f in dataclasses.fields(like)]
        if set(names) != set(saved):
            raise ValueError(f"{where}: fields {sorted(saved)} saved, {sorted(names)} expected")
        return dataclasses.replace(like, **{
            n: _restore_into(getattr(like, n), saved[n], f"{where}.{n}") for n in names})
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"{where}: keys {sorted(saved)} saved, {sorted(like)} expected")
        return {k: _restore_into(v, saved[k], f"{where}.{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(like) != len(saved):
            raise ValueError(f"{where}: {len(saved)} entries saved, {len(like)} expected")
        return type(like)(_restore_into(v, s, f"{where}[{i}]")
                          for i, (v, s) in enumerate(zip(like, saved)))
    return saved


class Checkpointer:
    """Step-indexed checkpoints of a training state under ``root``.

    Layout: ``<root>/<step>/`` per checkpoint, as the JAX package's, each
    holding ``state.pt``; ``latest_step()`` finds the resume point and
    ``keep`` bounds the checkpoints kept (the oldest are pruned). A state is
    anything :func:`_state_to_host` takes: the PPO ``TrainState`` (model
    parameters and BatchNorm statistics, Adam's moments and the schedule's
    count, the env state, the generator's state, ``update_idx``), or nested
    dicts of tensors and arrays.
    """

    def __init__(self, root: str | Path, keep: int = 5):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, tree: Any) -> Path:
        """Write ``tree`` as checkpoint ``step`` (replacing one of that
        step), then prune to ``keep``. Returns the checkpoint's directory."""
        path = self.root / str(step)
        tmp = self.root / f".{step}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(_state_to_host(tree), tmp / _STATE_FILE)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._prune()
        return path

    def restore(self, step: int | None = None, like: Any = None) -> Any:
        """Checkpoint ``step`` (default: the latest). With ``like`` (a state
        of the saved structure, on any device), the saved values restored
        into it: see :func:`_restore_into`; modules, optimisers and
        generators of ``like`` are loaded in place. Without it, the host
        copy as saved."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        saved = torch.load(self.root / str(step) / _STATE_FILE, weights_only=True)
        return saved if like is None else _restore_into(like, saved)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.root.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / str(step), ignore_errors=True)


def save_model(path: str | Path, variables: Any, meta: dict | None = None) -> None:
    """Pickle ``{"variables": variables as numpy, "meta": meta}`` to ``path``,
    the layout of the JAX package's ``save_model``, which its
    ``load_model`` and :func:`load_model` read."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"variables": _to_host(variables), "meta": meta or {}}, f)


def load_model(path: str | Path) -> tuple[Any, dict]:
    """``(variables, meta)`` of a ``save_model`` pickle."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob["variables"], blob.get("meta", {})


def bf16_bits_to_f32(u: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the float32 values they encode."""
    return (u.astype(np.uint32) << 16).view(np.float32)


def load_array_bf16(prefix: str | Path) -> tuple[np.ndarray, dict]:
    """Load a ``save_array_bf16`` artifact (``<prefix>.meta.json`` and
    ``<prefix>.p00``, ...) -> ``(f32 ndarray, meta)``. Stages 1.. of a table
    saved with ``delta_stages > 1`` were XORed with stage 0 in bf16 bits;
    the XOR is undone here."""
    prefix = Path(prefix)
    header = json.loads(prefix.with_name(prefix.name + ".meta.json").read_text())
    if header["format"] != "bf16_zlib_v1":
        raise ValueError(f"unknown artifact format {header['format']!r}")
    comp = b"".join(prefix.with_name(prefix.name + f".p{i:02d}").read_bytes()
                    for i in range(header["n_parts"]))
    raw = zlib.decompress(comp)
    if len(raw) != header["raw_bytes"]:
        raise ValueError(f"{len(raw)} bytes decompressed, header says "
                         f"{header['raw_bytes']}")
    u = np.frombuffer(raw, dtype=np.uint16)
    n_stages = header.get("delta_stages", 1)
    if n_stages > 1:
        u = u.reshape(n_stages, -1)
        u = np.concatenate([u[:1], u[1:] ^ u[:1]])  # XOR is its own inverse
    return bf16_bits_to_f32(u).reshape(header["shape"]), header["meta"]
