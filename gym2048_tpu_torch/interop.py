"""Carry state and weights between the JAX package and the port, through numpy.

The JAX package's ``EnvState``, cell-major boards and n-tuple tables leave
it as numpy arrays (``np.asarray``); these helpers copy them into the port's
tensors so that both packages can start from the same state, and build the
port's network from a JAX meta/config so that both evaluate the same one.

The CNNs' weight map (:func:`resnet_state_dict`, :func:`resnet_variables`)
goes both ways between a JAX ``Game2048Model`` / ``ActorCritic`` variable
tree (``{"params", "batch_stats"}`` as numpy, as ``utils/checkpoint.load_model``
returns it) and the port's modules: a flax conv kernel ``(kH, kW, I, O)`` is
a torch weight ``(O, I, kH, kW)``, and a dense kernel over the (h, w, c)
flatten ``(P * C, out)`` is a torch weight ``(out, C * P)`` over the
(c, h, w) flatten. Both are transposes, so a round trip is exact. This is
the port's one layout map: ``tools/convert_model.py`` builds on it
(:func:`variables_from_state_dict`) for the reference's torch and SB3 files.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from gym2048_tpu_torch.core.fused_step import to_cell_major
from gym2048_tpu_torch.env.batched import EnvState
from gym2048_tpu_torch.models.ntuple import SmallNet
from gym2048_tpu_torch.models.ntuple_big import NTupleNetwork, make_network
from gym2048_tpu_torch.models.resnet import ActorCritic, Game2048Model


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


# ------------------------------------------------------------- CNN weights

def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    """flax Conv kernel (kH, kW, I, O) -> torch Conv2d weight (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _conv_to_flax(t: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(t, (2, 3, 1, 0)))


def _fc_to_torch(k: np.ndarray, channels: int) -> np.ndarray:
    """flax Dense kernel (P * C, out) over channel-minor (h, w, c) features
    -> torch Linear weight (out, C * P) over channel-major (c, h, w) ones."""
    out = k.shape[1]
    k = k.reshape(-1, channels, out)              # (p, c, out)
    return np.ascontiguousarray(np.transpose(k, (2, 1, 0)).reshape(out, -1))


def _fc_to_flax(w: np.ndarray, channels: int) -> np.ndarray:
    out = w.shape[0]
    w = w.reshape(out, channels, -1)              # (out, c, p)
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)).reshape(-1, out))


def _resnet_entries(kind: str, blocks: int, filters: int):
    """``(torch name, JAX collection, JAX path, transform)`` of every array
    of a ``kind`` model; the transform is ``"conv"``, ``("fc", channels)``
    or ``None`` (as is)."""
    trunk = ("trunk",) if kind == "Game2048Model" else ("_Trunk_0",)

    def bn(name, path):
        return [(f"{name}.weight", "params", path + ("scale",), None),
                (f"{name}.bias", "params", path + ("bias",), None),
                (f"{name}.running_mean", "batch_stats", path + ("mean",), None),
                (f"{name}.running_var", "batch_stats", path + ("var",), None)]

    out = [("initial_conv.weight", "params", trunk + ("Conv_0", "kernel"), "conv"),
           *bn("initial_bn", trunk + ("BatchNorm_0",))]
    for i in range(blocks):
        block = trunk + (f"ResidualBlock_{i}",)
        for j in (0, 1):
            out += [(f"res_blocks.{i}.conv{j + 1}.weight", "params",
                     block + (f"Conv_{j}", "kernel"), "conv"),
                    *bn(f"res_blocks.{i}.bn{j + 1}", block + (f"BatchNorm_{j}",))]
    if kind == "Game2048Model":
        out += [("policy_conv.weight", "params", ("policy_conv", "kernel"), "conv"),
                *bn("policy_bn", ("policy_bn",)),
                ("policy_fc.weight", "params", ("policy_fc", "kernel"), ("fc", 2)),
                ("policy_fc.bias", "params", ("policy_fc", "bias"), None)]
    else:
        for head in ("policy_head", "value_head"):
            out += [(f"{head}.weight", "params", (head, "kernel"), ("fc", filters)),
                    (f"{head}.bias", "params", (head, "bias"), None)]
    return out


def _resnet_shape(variables: Mapping) -> tuple[str, int, int]:
    """``(kind, residual_blocks, filters)`` of a JAX CNN variable tree."""
    params = variables["params"]
    kind = "Game2048Model" if "trunk" in params else "ActorCritic"
    trunk = params["trunk" if kind == "Game2048Model" else "_Trunk_0"]
    blocks = sum(k.startswith("ResidualBlock_") for k in trunk)
    return kind, blocks, int(np.shape(trunk["Conv_0"]["kernel"])[-1])


def resnet_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``Game2048Model`` or ``ActorCritic`` variables as numpy -> the
    port's ``state_dict`` (CPU tensors, ``num_batches_tracked`` 0) for
    ``load_state_dict``."""
    kind, blocks, filters = _resnet_shape(variables)
    sd = {}
    for name, coll, path, how in _resnet_entries(kind, blocks, filters):
        a = variables[coll]
        for key in path:
            a = a[key]
        a = np.asarray(a, np.float32)
        if how == "conv":
            a = _conv_to_torch(a)
        elif how is not None:
            a = _fc_to_torch(a, how[1])
        sd[name] = torch.from_numpy(np.array(a, copy=True))
        if name.endswith("running_var"):
            sd[name[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def resnet_variables(model: Game2048Model | ActorCritic) -> dict:
    """Inverse of :func:`resnet_state_dict`: the port's model -> the JAX
    variable tree ``{"params", "batch_stats"}`` of float32 numpy arrays,
    which the port's and the JAX package's ``save_model`` write."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return variables_from_state_dict(sd, type(model).__name__, model.residual_blocks,
                                     model.filters)


def variables_from_state_dict(sd: Mapping, kind: str, blocks: int, filters: int) -> dict:
    """A state dict with the port's (the reference torch models') names, as
    numpy arrays, of a ``kind`` model (``"Game2048Model"`` or
    ``"ActorCritic"``) -> the JAX variable tree ``{"params",
    "batch_stats"}``; entries the tree has no place for
    (``num_batches_tracked``) are dropped, dtypes are kept."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, coll, path, how in _resnet_entries(kind, blocks, filters):
        a = np.asarray(sd[name])
        if how == "conv":
            a = _conv_to_flax(a)
        elif how is not None:
            a = _fc_to_flax(a, how[1])
        node = tree[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(a, copy=True)
    return tree


def resnet_from_variables(variables: Mapping, dtype: torch.dtype = torch.float32,
                          device: str | torch.device = "cuda") -> Game2048Model | ActorCritic:
    """The port's model (eval mode, on ``device``) holding JAX CNN
    variables; its kind, filters and blocks are read off the tree."""
    kind, blocks, filters = _resnet_shape(variables)
    cls = Game2048Model if kind == "Game2048Model" else ActorCritic
    model = cls(filters=filters, residual_blocks=blocks, dtype=dtype, device=device)
    model.load_state_dict(resnet_state_dict(variables))
    return model
