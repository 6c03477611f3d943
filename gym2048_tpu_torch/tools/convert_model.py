"""Model-weight interop: the flax-layout ``.pkl``/``.npz`` <-> the reference's
torch ``.pth``/``.pt`` and SB3 ``.zip`` (counterpart of
``gym2048_tpu/tools/convert_model.py``).

The reference persists weights two ways:

* ``torch.save(model, path)`` — the whole pickled ``Game2048Model``
  (reference train.py:289), or its ``state_dict``;
* SB3 ``model.save(path)`` — a ``.zip`` whose ``policy.pth`` holds the
  policy state_dict (reference ppo_train.py:185-186, extractor layout
  ppo_train.py:34-62).

This tool maps those to the flax variable tree that both packages'
``save_model`` files and ``.npz`` archives hold, and back. The layout map
(a conv weight ``(O, I, kH, kW)`` is a flax kernel ``(kH, kW, I, O)``, a
dense weight over the (c, h, w) flatten is a kernel over the (h, w, c) one,
BatchNorm's ``weight``/``bias``/``running_*`` are ``scale``/``bias`` and
``mean``/``var``) is the port's one map, :mod:`gym2048_tpu_torch.interop`:
the reference's Game2048Model names are the port's own, and an SB3 policy's
names are renamed to the port's ActorCritic ones first. Format and
direction follow the file extensions:

    python -m gym2048_tpu_torch.tools.convert_model model.pth model.pkl
    python -m gym2048_tpu_torch.tools.convert_model ppo_model.zip policy.npz
    python -m gym2048_tpu_torch.tools.convert_model model.pkl model.pth

Nothing here needs the card: the conversion is numpy, and torch files are
read onto the CPU.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from gym2048_tpu_torch import interop

# ------------------------------------------------------------------ flat io

_META_KEY = "__meta__"


def flatten_variables(variables) -> dict[str, np.ndarray]:
    """Nested flax variables -> flat ``{'params/trunk/Conv_0/kernel': arr}``."""
    out: dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            out[prefix] = np.asarray(node)

    walk("", variables)
    return out


def unflatten_variables(flat: dict[str, np.ndarray]):
    """Inverse of :func:`flatten_variables`."""
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr)
    return root


def save_npz(path, variables, meta: dict | None = None) -> None:
    """Write flax variables (+ JSON meta under ``__meta__``) to a flat
    ``.npz`` archive, which the JAX package's ``load_npz`` reads."""
    flat = flatten_variables(variables)
    flat[_META_KEY] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_npz(path):
    """Read a :func:`save_npz` archive (either package's) -> ``(variables, meta)``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY]).decode()) if _META_KEY in z.files else {}
    return unflatten_variables(flat), meta


# ------------------------------------------------------------ the two models

def _count(sd, key: str, start: int = 0) -> int:
    """How many of ``key.format(i)`` for i = start, start + 1, ... are in
    ``sd`` before the first that is not."""
    i = start
    while key.format(i) in sd:
        i += 1
    return i - start


def torch_to_flax_game2048(sd: dict):
    """Reference ``Game2048Model.state_dict()`` (arrays or tensors) -> flax
    variables ``{'params': ..., 'batch_stats': ...}`` and the inferred
    config ``{"model", "filters", "residual_blocks"}``."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    blocks = _count(sd, "res_blocks.{}.conv1.weight")
    filters = int(sd["policy_conv.weight"].shape[1])
    variables = interop.variables_from_state_dict(sd, "Game2048Model", blocks, filters)
    return variables, {"model": "Game2048Model", "filters": filters,
                       "residual_blocks": blocks}


def flax_to_torch_game2048(variables) -> dict[str, np.ndarray]:
    """Inverse: flax Game2048Model variables -> reference state_dict arrays
    (``num_batches_tracked`` 0; wrap in ``torch.from_numpy`` to load)."""
    return {k: v.numpy() for k, v in interop.resnet_state_dict(variables).items()}


def sb3_to_flax_actor_critic(sd: dict):
    """SB3 policy state_dict (CnnPolicy + ResNetExtractor, ppo_train.py:34-62
    with ``net_arch=[]``) -> flax ActorCritic variables and config.

    The extractor's Sequential: 0 conv, 1 bn, 2 relu, 3..3+R-1 residual
    blocks; ``features_extractor`` is preferred, ``pi_features_extractor``
    accepted (SB3 saves per-head aliases when the extractor is shared).
    Raises ``KeyError`` for a state dict that is no such policy."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    for fe in ("features_extractor", "pi_features_extractor"):
        if f"{fe}.trunk.0.weight" in sd:
            break
    else:
        raise KeyError("no features_extractor.trunk.0.weight in state_dict — not an "
                       "SB3 ResNetExtractor policy")
    blocks = _count(sd, fe + ".trunk.{}.conv1.weight", start=3)
    renamed = {}
    for key, value in sd.items():
        head, _, rest = key.partition(".")
        if head == "action_net":
            renamed[f"policy_head.{rest}"] = value
        elif head == "value_net":
            renamed[f"value_head.{rest}"] = value
        elif key.startswith(f"{fe}.trunk."):
            index, _, leaf = key[len(fe) + 7:].partition(".")
            i = int(index)
            name = ("initial_conv" if i == 0 else "initial_bn" if i == 1
                    else f"res_blocks.{i - 3}")
            renamed[f"{name}.{leaf}"] = value
    filters = int(sd[f"{fe}.trunk.0.weight"].shape[0])
    variables = interop.variables_from_state_dict(renamed, "ActorCritic", blocks, filters)
    return variables, {"model": "ActorCritic", "filters": filters,
                       "residual_blocks": blocks}


# ----------------------------------------------------------- file loaders

def _numpy_state_dict(blob) -> dict[str, np.ndarray]:
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in blob.items()}


def _torch_load(f):
    """``torch.load`` onto the CPU: tensors only where that suffices, else
    any pickle (a whole module, whose class must then be importable)."""
    try:
        return torch.load(f, map_location="cpu", weights_only=True)
    except Exception:
        if hasattr(f, "seek"):
            f.seek(0)
        return torch.load(f, map_location="cpu", weights_only=False)


def load_torch_file(path) -> dict[str, np.ndarray]:
    """A ``.pth``/``.pt`` file -> numpy state_dict: a plain state_dict or a
    whole pickled module (the reference's train.py:289 saves the module)."""
    return _numpy_state_dict(_torch_load(path))


def load_sb3_zip(path) -> dict[str, np.ndarray]:
    """The policy state_dict of an SB3 ``.zip`` save."""
    with zipfile.ZipFile(path) as z:
        name = next((n for n in z.namelist() if n.endswith("policy.pth")), None)
        if name is None:
            raise SystemExit(f"{path}: no policy.pth inside — not an SB3 model zip "
                             f"(contains {z.namelist()})")
        with z.open(name) as f:
            buf = io.BytesIO(f.read())
    return _numpy_state_dict(_torch_load(buf))


def save_torch_file(path, variables, meta) -> None:
    """Export flax Game2048Model variables as a torch state_dict file that
    the reference's ``model.load_state_dict`` (and the port's) accepts."""
    if meta.get("model") == "ActorCritic":
        raise SystemExit("torch export implemented for Game2048Model (the reference's "
                         "only torch-file model); export ActorCritic to .npz instead")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_to_torch_game2048(variables).items()}
    torch.save(sd, path)


# ------------------------------------------------------------------- CLI

def main(argv=None) -> None:
    import argparse

    from gym2048_tpu_torch.utils.checkpoint import load_model, save_model

    p = argparse.ArgumentParser(
        description="Convert model weights between the flax layout (.pkl/.npz, both "
        "packages) and the reference's torch (.pth/.pt) / SB3 (.zip) formats; "
        "direction and format follow the file extensions.")
    p.add_argument("input", help=".pkl | .npz | .pth/.pt | .zip")
    p.add_argument("output", help=".pkl | .npz | .pth/.pt")
    args = p.parse_args(argv)

    src, dst = Path(args.input), Path(args.output)
    s_ext, d_ext = src.suffix.lower(), dst.suffix.lower()

    if s_ext == ".pkl":
        variables, meta = load_model(src)
    elif s_ext == ".npz":
        variables, meta = load_npz(src)
    elif s_ext in (".pth", ".pt"):
        variables, meta = torch_to_flax_game2048(load_torch_file(src))
    elif s_ext == ".zip":
        variables, meta = sb3_to_flax_actor_critic(load_sb3_zip(src))
    else:
        raise SystemExit(f"unsupported input format: {src}")

    if d_ext == ".pkl":
        save_model(dst, variables, meta=meta)
    elif d_ext == ".npz":
        save_npz(dst, variables, meta)
    elif d_ext in (".pth", ".pt"):
        save_torch_file(dst, variables, meta)
    else:
        raise SystemExit(f"unsupported output format: {dst}")
    print(f"wrote {dst} (meta: {json.dumps(meta)})")


if __name__ == "__main__":
    main()
