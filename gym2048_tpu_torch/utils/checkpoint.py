"""Save and load the JAX package's model files, and load its table artifacts.

Counterpart of ``gym2048_tpu/utils/checkpoint.py``'s one-shot model files:
:func:`save_model` and :func:`load_model` (a pickle of numpy arrays) and
:func:`load_array_bf16` (the ``bf16_zlib_v1`` artifacts of
``save_array_bf16``, such as the committed n-tuple tables). bf16 is the
top half of an f32, so the artifact is decoded without ``ml_dtypes``: each
16-bit word shifted into the high half of a 32-bit word is the f32 it
stands for. Orbax's ``Checkpointer`` is not ported yet.
"""

from __future__ import annotations

import json
import pickle
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
