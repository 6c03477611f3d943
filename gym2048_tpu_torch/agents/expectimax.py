"""Batched expectimax search for 2048, in PyTorch.

Counterpart of ``gym2048_tpu/agents/expectimax.py``. The JAX module
searches one board and is batched with ``vmap``; here every function takes
a batch of boards ``(B, 4, 4)`` and the tree's levels are batch dimensions
written out, so one search of B boards issues the same tensor operations
whatever B is.

Two searches:

* the heuristic search (:func:`action_values`, :func:`state_value`,
  :func:`make_policy`): ``depth`` (move, spawn) plies before a leaf value
  of the *state*, by default the hand-tuned :func:`heuristic_value`;
* the afterstate search (:func:`_afterstate_search`,
  :func:`make_afterstate_policy`, :func:`make_adaptive_policy`): a value
  function of *afterstates* in score units, such as an n-tuple network's
  :meth:`~gym2048_tpu_torch.models.ntuple_big.NTupleNetwork.value_batch`,
  read after the last move of each branch. The flagship agent is the
  adaptive one: depth 2 for every board, depth 3 (beam-pruned) for the
  ``k_deep`` most constrained live boards.

Leaf and dead-board value functions map ``(N, 4, 4)`` boards to ``(N,)``
float32 values (the JAX module's map one board to a scalar). Everything is
float32. Where the JAX module evaluates the 32 spawn children of a deep
level one after another with ``lax.map``, the port loops over the 32 spawn
slices: the same values, with a bounded batch. :func:`play_policy` plays
games on the port's batched env with a ``torch.Generator``; entry points run
on the card (``device="cuda"``) unless the caller asks for the CPU.

:func:`value_leaf_from_critic` makes a PPO critic the leaf of the
heuristic search: all N leaf boards go through one eval-mode forward of the
:class:`~gym2048_tpu_torch.models.resnet.ActorCritic`, where the JAX
module applies the model to one board at a time under ``vmap``; with
BatchNorm in eval mode the two are the same function.
"""

from __future__ import annotations

from typing import Callable

import torch

from gym2048_tpu_torch.core import rules
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.env.batched import EnvConfig
from gym2048_tpu_torch.models.resnet import boards_to_model_input

# Heuristic weights (exponent units), as in the JAX module.
W_EMPTY = 2.7
W_MONO = 1.4
W_SMOOTH = 0.2
W_MAX = 1.0
W_CORNER = 2.0
# Exchange rate between merge score (raw tile values) and the heuristic's
# exponent units; use 1.0 for leaves in score units.
W_GAIN = 0.35
DEATH = 200.0
_NEG = -1e9

ValueFn = Callable[[torch.Tensor], torch.Tensor]


def heuristic_value(boards: torch.Tensor) -> torch.Tensor:
    """Heuristic value ``(N,)`` float32 of ``(N, 4, 4)`` exponent boards:
    empty cells, monotonicity, smoothness, max tile and corner."""
    e = boards.to(torch.float32)
    empty = (boards == 0).flatten(-2).sum(-1).to(torch.float32)
    dr = e[..., :, 1:] - e[..., :, :-1]  # (N, 4, 3)
    dc = e[..., 1:, :] - e[..., :-1, :]  # (N, 3, 4)
    # per line, the smaller of the increasing / decreasing breakage
    mono = (torch.minimum(dr.clamp_min(0.0).sum(-1), (-dr).clamp_min(0.0).sum(-1)).sum(-1)
            + torch.minimum(dc.clamp_min(0.0).sum(-2), (-dc).clamp_min(0.0).sum(-2)).sum(-1))
    smooth = dr.abs().sum((-2, -1)) + dc.abs().sum((-2, -1))
    m = e.flatten(-2).amax(-1)
    corners = torch.stack([e[..., 0, 0], e[..., 0, 3], e[..., 3, 0], e[..., 3, 3]], -1)
    corner_bonus = torch.where((corners == m[..., None]).any(-1), m, 0.0)
    return (W_EMPTY * empty + W_MAX * m + W_CORNER * corner_bonus
            - W_MONO * mono - W_SMOOTH * smooth)


def heuristic_dead_value(boards: torch.Tensor) -> torch.Tensor:
    """Dead-board value for the heuristic leaf: the leaf minus ``DEATH``."""
    return heuristic_value(boards) - DEATH


def bellman_dead_value(boards: torch.Tensor) -> torch.Tensor:
    """Dead-board value for score-unit leaves: the Bellman terminal 0."""
    return torch.zeros(boards.shape[0], dtype=torch.float32, device=boards.device)


def spawn_children(boards: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All 32 spawn outcomes of ``(N, 4, 4)`` afterstates and their
    probabilities: ``(children (N, 32, 4, 4), probs (N, 32) float32)``.
    Child ``j < 16`` holds a 2 (exponent 1) at cell ``j``, child ``16 + j``
    a 4; an occupied cell's children get probability 0."""
    n = boards.shape[0]
    flat = boards.reshape(n, 16)
    empty = flat == 0
    p_cell = torch.where(empty, 1.0 / empty.sum(-1).clamp_min(1)[:, None], 0.0)
    eye = torch.eye(16, dtype=boards.dtype, device=boards.device)
    children = torch.cat([flat[:, None, :] + eye, flat[:, None, :] + 2 * eye], 1)
    probs = torch.cat([0.9 * p_cell, 0.1 * p_cell], 1)
    return children.reshape(n, 32, 4, 4), probs


def action_values(boards: torch.Tensor, depth: int,
                  leaf_value: ValueFn = heuristic_value,
                  gain_weight: float = W_GAIN,
                  dead_value: ValueFn | None = None) -> torch.Tensor:
    """Expectimax Q-values ``(B, 4)`` of ``(B, 4, 4)`` boards: an illegal
    action gets ``_NEG``, a legal one ``gain_weight * merge_score +
    E_spawn[state_value(child, depth - 1)]``. From ``depth`` 3 on, the 32
    spawn slices are searched one after another to bound the batch."""
    b = boards.shape[0]
    moved, scores, legal = rules.move_all(boards)
    children, probs = spawn_children(moved.reshape(b * 4, 4, 4))

    def child_value(ch):
        return state_value(ch, depth - 1, leaf_value, gain_weight, dead_value)

    if depth >= 3:
        vals = torch.stack([child_value(children[:, j]) for j in range(32)], 1)
    else:
        vals = child_value(children.reshape(b * 128, 4, 4)).reshape(b * 4, 32)
    q = gain_weight * scores.to(torch.float32) + (vals * probs).sum(-1).reshape(b, 4)
    return torch.where(legal, q, _NEG)


def state_value(boards: torch.Tensor, depth: int,
                leaf_value: ValueFn = heuristic_value,
                gain_weight: float = W_GAIN,
                dead_value: ValueFn | None = None) -> torch.Tensor:
    """Expectimax value ``(B,)`` of states; a dead board gets
    ``dead_value`` (default :func:`heuristic_dead_value`)."""
    if dead_value is None:
        dead_value = heuristic_dead_value
    if depth == 0:
        return leaf_value(boards)
    q = action_values(boards, depth, leaf_value, gain_weight, dead_value)
    dead = (q <= _NEG / 2).all(-1)
    return torch.where(dead, dead_value(boards), q.amax(-1))


def value_leaf_from_critic(model) -> ValueFn:
    """A trained :class:`~gym2048_tpu_torch.models.resnet.ActorCritic`'s
    value head as a ``leaf_value``: ``(N, 4, 4)`` boards -> ``(N,)``
    float32 in one eval-mode forward, without gradients. Search on top of
    learning: expectimax backs up the critic's state value instead of the
    hand-tuned heuristic. Pair it with ``gain_weight=1.0`` and
    :func:`bellman_dead_value`."""
    def leaf(boards: torch.Tensor) -> torch.Tensor:
        if model.training:
            raise ValueError("value_leaf_from_critic reads the critic in eval mode")
        with torch.no_grad():
            _, value = model(boards_to_model_input(boards))
        return value

    return leaf


def make_policy(depth: int, leaf_value: ValueFn = heuristic_value,
                gain_weight: float = W_GAIN,
                dead_value: ValueFn | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Greedy expectimax policy: boards ``(B, 4, 4)`` -> actions ``(B,)``
    int32. For leaves in score units pass ``gain_weight=1.0`` and
    ``dead_value=bellman_dead_value``."""

    def policy(boards: torch.Tensor) -> torch.Tensor:
        q = action_values(boards, depth, leaf_value, gain_weight, dead_value)
        return q.argmax(-1).to(torch.int32)

    return policy


def _afterstate_search(value_fn: ValueFn, boards: torch.Tensor, plies: int,
                       beam: bool = False, map_spawn: bool = True) -> torch.Tensor:
    """Afterstate-expectimax Q-values ``(B, 4)`` at ``plies`` move levels.

    ``plies`` counts the moves along a branch before ``value_fn`` is read
    at the last afterstate: 1 is ``r + V(after)``, and each further ply
    inserts a spawn expectation and a max over the next moves. Dead spawn
    children are worth 0. At ``plies >= 3`` with ``map_spawn`` the first
    spawn level is searched one of its 32 slices at a time.

    ``beam`` prunes at ``plies == 2``: only the move that wins the shallow
    backup ``r + V(after)`` is expanded through its spawn expectation; the
    other moves keep their shallow values.
    """
    b = boards.shape[0]
    moved, scores, legal = rules.move_all(boards)
    scores = scores.to(torch.float32)
    if plies == 1:
        v = value_fn(moved.reshape(b * 4, 4, 4)).reshape(b, 4)
        return torch.where(legal, scores + v, _NEG)

    def child_state_values(ch):
        q = _afterstate_search(value_fn, ch, plies - 1, beam, map_spawn)
        return torch.where((q > _NEG / 2).any(-1), q.amax(-1), 0.0)

    if beam and plies == 2:
        v1 = value_fn(moved.reshape(b * 4, 4, 4)).reshape(b, 4)
        q_shallow = torch.where(legal, scores + v1, _NEG)
        a = q_shallow.argmax(-1, keepdim=True)  # (b, 1)
        best_after = moved.gather(1, a[:, :, None, None].expand(b, 1, 4, 4))[:, 0]
        children, probs = spawn_children(best_after)
        sv = child_state_values(children.reshape(b * 32, 4, 4)).reshape(b, 32)
        q_deep = scores.gather(1, a) + (sv * probs).sum(-1, keepdim=True)
        return q_shallow.scatter(1, a, torch.where(legal.gather(1, a), q_deep, _NEG))

    children, probs = spawn_children(moved.reshape(b * 4, 4, 4))
    if plies >= 3 and map_spawn:
        sv = torch.stack([child_state_values(children[:, j]) for j in range(32)], 1)
    else:
        sv = child_state_values(children.reshape(b * 128, 4, 4)).reshape(b * 4, 32)
    ev = (sv * probs).sum(-1).reshape(b, 4)
    return torch.where(legal, scores + ev, _NEG)


def make_afterstate_policy(value_fn: Callable[..., torch.Tensor], depth: int = 2,
                           parametrised: bool = False, beam: bool = False):
    """Expectimax over an afterstate value function: ``policy(boards)``, or
    with ``parametrised`` ``value_fn(params, boards)`` and
    ``policy(params, boards)``, returning ``(B,)`` int32 actions.

    depth 1 is the greedy TD policy ``argmax_a [r + V(after)]``; depth 2
    adds a spawn expectation and a max; depth 3 one more level, with
    ``beam`` pruning its pre-leaf max level (see :func:`_afterstate_search`).
    """
    if depth not in (1, 2, 3):
        raise ValueError("afterstate search supports depth 1, 2 or 3")

    if parametrised:
        def policy(params, boards: torch.Tensor) -> torch.Tensor:
            q = _afterstate_search(lambda bs: value_fn(params, bs), boards, depth, beam)
            return q.argmax(-1).to(torch.int32)
    else:
        def policy(boards: torch.Tensor) -> torch.Tensor:
            q = _afterstate_search(value_fn, boards, depth, beam)
            return q.argmax(-1).to(torch.int32)

    return policy


def _deep_set(boards: torch.Tensor, active: torch.Tensor, k_deep: int,
              deep_empty_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The adaptive policy's deep set: the indices ``(k,)`` of the
    ``k = min(k_deep, B)`` boards of most danger (fewest empty cells) among
    the live boards with at most ``deep_empty_max`` empties, and whether
    each of them qualifies ``(k,)``. Ties go to the lower index, as with
    ``jax.lax.top_k``: a stable descending sort."""
    b = boards.shape[0]
    empties = (boards.reshape(b, 16) == 0).sum(-1)
    eligible = active & (empties <= deep_empty_max)
    danger = torch.where(eligible, -empties, -(10 ** 6))
    top = torch.sort(danger, descending=True, stable=True).indices[:min(k_deep, b)]
    return top, eligible[top]


def make_adaptive_policy(value_fn: Callable[..., torch.Tensor], k_deep: int,
                         deep_empty_max: int = 8, beam: bool = True,
                         map_spawn: bool = False):
    """Adaptive-depth afterstate expectimax, ``policy(params, boards,
    active)`` -> ``(B,)`` int32 actions with ``value_fn(params, boards)``:

    1. depth-2 Q-values for every board;
    2. the deep set (:func:`_deep_set`): the ``k_deep`` live boards with the
       fewest empty cells, at most ``deep_empty_max``;
    3. depth-3 Q-values (``beam`` pruned, the whole level in one batch
       unless ``map_spawn``) for those boards, which replace their rows.

    Pass ``play_policy(..., needs_active=True)``.
    """

    def policy(params, boards: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        vf = lambda bs: value_fn(params, bs)
        q2 = _afterstate_search(vf, boards, 2)
        top, take = _deep_set(boards, active, k_deep, deep_empty_max)
        q3 = _afterstate_search(vf, boards[top], 3, beam, map_spawn)
        q = q2.index_copy(0, top, torch.where(take[:, None], q3, q2[top]))
        return q.argmax(-1).to(torch.int32)

    return policy


def play_policy(policy: Callable[..., torch.Tensor], episodes: int,
                generator: torch.Generator | None = None, move_cap: int = 20000,
                chunk_moves: int = 128, params=None, needs_active: bool = False,
                device: str | torch.device = "cuda") -> dict:
    """Play ``episodes`` games in lockstep with a batched policy
    ``(B, 4, 4) boards -> (B,)`` actions on the port's env (no auto-reset),
    drawing every spawn from ``generator`` (default: seed 0 on ``device``).

    ``params`` is passed first to the policy when given, and with
    ``needs_active`` the live-game mask last. Moves run in chunks of
    ``chunk_moves``; after each chunk the host stops once no game is live
    or ``move_cap`` is reached. Returns the JAX module's evaluation dict.
    """
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cfg = EnvConfig(auto_reset=False)
    state = batched.reset(generator, episodes, device=device)
    total = torch.zeros(episodes, dtype=torch.float32, device=device)
    moves = torch.zeros(episodes, dtype=torch.int32, device=device)
    high = torch.zeros(episodes, dtype=torch.int32, device=device)
    active = torch.ones(episodes, dtype=torch.bool, device=device)
    t = 0
    while t < move_cap:
        for _ in range(chunk_moves):
            args = (state.board, active) if needs_active else (state.board,)
            action = policy(*args) if params is None else policy(params, *args)
            state, ts = batched.step(state, action, cfg, generator=generator)
            total += torch.where(active, ts.reward, 0.0)
            moves += active.to(torch.int32)
            high = torch.where(active, ts.highest, high)
            active = active & ~ts.terminated
        t += chunk_moves
        if not bool(active.any()):  # one host sync per chunk
            break
    total, moves, high = (x.cpu().tolist() for x in (total, moves, high))
    return {
        "Average score": sum(total) / episodes,
        "Max score": max(total),
        "Highest tile": max(high),
        "Episodes": [{"total_reward": total[i], "highest": high[i], "moves": moves[i]}
                     for i in range(episodes)],
    }


def play_batched(episodes: int, depth: int = 2,
                 generator: torch.Generator | None = None, move_cap: int = 20000,
                 leaf_value: ValueFn = heuristic_value, gain_weight: float = W_GAIN,
                 dead_value: ValueFn | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Play full games with the heuristic-leaf expectimax of
    :func:`make_policy`, driven by :func:`play_policy`."""
    return play_policy(make_policy(depth, leaf_value, gain_weight, dead_value),
                       episodes, generator, move_cap, device=device)


def main(argv: list[str] | None = None) -> None:
    import argparse
    import collections
    import json

    p = argparse.ArgumentParser(
        description="Play 2048 with batched expectimax search (PyTorch).")
    p.add_argument("--episodes", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--move-cap", type=int, default=20000)
    p.add_argument("--table", default=None,
                   help="n-tuple table .pkl (save_model format with the "
                   "network's config in its meta): search over AFTERSTATE "
                   "values instead of the heuristic leaf")
    p.add_argument("--value-impl", choices=("auto", "gather", "mxu", "mxu_bf16"),
                   default="auto",
                   help="small-net table lookups: gather (auto; exact), mxu (the bf16 "
                   "split halves, ~2**-16) or mxu_bf16 (the hi half alone); big nets "
                   "have one lookup")
    p.add_argument("--beam", action="store_true",
                   help="depth-3 greedy forward pruning at the pre-leaf max level")
    p.add_argument("--adaptive", type=int, default=0, metavar="K",
                   help="adaptive depth (table mode): depth 2 for all boards "
                   "plus depth-3 beam re-search of the K most constrained "
                   "live boards per move (--depth is ignored)")
    p.add_argument("--deep-empty-max", type=int, default=8,
                   help="adaptive mode: only boards with at most this many "
                   "empty cells qualify for the deep re-search")
    p.add_argument("--chunk-moves", type=int, default=128,
                   help="moves between the host's checks for live games")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    if args.table:
        from gym2048_tpu_torch import interop
        from gym2048_tpu_torch.models.ntuple import SmallNet
        from gym2048_tpu_torch.utils.checkpoint import load_model

        variables, meta = load_model(args.table)
        try:
            net = interop.network_from_config(meta.get("config") or {}, args.value_impl)
        except ValueError as e:
            p.error(str(e))
        table = interop.table_from_numpy(variables["table"], device)
        if isinstance(net, SmallNet):  # the split halves, once, in the "mxu" modes
            table = net.params(table)
        if args.adaptive:
            pol = make_adaptive_policy(net.value_batch, args.adaptive,
                                       args.deep_empty_max)
        else:
            pol = make_afterstate_policy(net.value_batch, args.depth,
                                         parametrised=True, beam=args.beam)
        result = play_policy(pol, args.episodes, generator, args.move_cap,
                             chunk_moves=args.chunk_moves, params=table,
                             needs_active=bool(args.adaptive), device=device)
    else:
        result = play_batched(args.episodes, args.depth, generator, args.move_cap,
                              device=device)
    dist = collections.Counter(e["highest"] for e in result["Episodes"])
    print(json.dumps({
        "episodes": args.episodes,
        "depth": args.depth,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "Average score": result["Average score"],
        "Max score": result["Max score"],
        "Highest tile": result["Highest tile"],
        "tile_distribution": dict(sorted(dist.items())),
    }))


if __name__ == "__main__":
    main()
