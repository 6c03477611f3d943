"""TD(0) afterstate learning of the n-tuple networks, in PyTorch.

Counterpart of ``gym2048_tpu/train/td.py``, for the small 17 x 4-cell net
of :mod:`gym2048_tpu_torch.models.ntuple` (``arch == "small"``, the
default) and the layouts of :mod:`gym2048_tpu_torch.models.ntuple_big`. A
value function V over afterstates (the board after the slide, before the
spawn) is learnt by one-step temporal differences:

    a*  = argmax_a [ r(s, a) + V(after(s, a)) ]
    TD:   V(after(s, a*)) += alpha * (r' + V(after(s'', a*')) - V(after))

Thousands of games advance in lockstep. Each step evaluates the 4 candidate
afterstates of every board with one lookup (the table gather kernel on the
card), updates the table for the previous step's afterstate by a
count-normalised scatter, spawns, and restarts finished games. Options, as
in JAX: temporal coherence (``tc``, per-entry adaptive rates); for the big
nets also delayed TC (``tc_every``: the table-sized TC combine once per
window of steps, the statistics scatter-accumulated in between), staged
tables (``thresholds``) and carousel restarts (``carousel``: finished games
restart from recorded stage-entry boards), all from arXiv:1604.05085.

The small net's value modes are the JAX package's: ``"gather"`` (the exact
lookup; ``"auto"`` here, as in JAX off the TPU), ``"mxu"`` (two lookups into
the bf16 split halves of the table, split once a step) and ``"mxu_bf16"``
(the ``hi`` half alone). Its ``update_impl`` ``"mxu"`` names a matmul form
of the scatter for the TPU with the scatter's sums; every choice runs the
scatter here.

Randomness: one ``torch.Generator`` on the trainer's device, seeded from
``TDConfig.seed``, takes the place of the JAX key. It is carried in the
train state under ``"generator"`` and advances as the state is trained.
:meth:`TDTrainer._draws` draws each step's uniforms in one call, and the
step body takes them as an argument, so the body can be fed the numbers
JAX drew. The steps of a chunk are a Python loop with no host sync;
:meth:`TDTrainer.learn` syncs once per logged chunk.

Not ported here: the data-parallel chunk (``make_sharded_chunk``,
``shard_td_state``, ``--sharded``); each raises and names its item in
``ROADMAP.md``.

Run: ``python -m gym2048_tpu_torch.train.td`` (the small net) or ``--arch
4x6 --tc --alpha 1 --alpha-final 1 --init-value 0`` on the card, ``--device
cpu`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from gym2048_tpu_torch import interop
from gym2048_tpu_torch.core import rules
from gym2048_tpu_torch.env.batched import _fresh_boards
from gym2048_tpu_torch.models import ntuple, ntuple_big
from gym2048_tpu_torch.models.ntuple import _tc_combine, stage_of_batch
from gym2048_tpu_torch.utils.checkpoint import load_model, save_model

SHARDED_NOT_PORTED = ("data-parallel TD training is not ported yet (ROADMAP.md, "
                      "Queue 1 item 7)")

_PENDING = ("tc_ps", "tc_pa", "tc_pc")  # delayed-TC sums, |sums|, counts
_SYNC_EVERY = 64  # play_greedy's moves between host checks for a live game


@dataclasses.dataclass(frozen=True)
class TDConfig:
    """The JAX ``TDConfig``, every field with its default. ``update_impl``
    and ``value_impl`` name the JAX package's implementations; every update
    choice is the one scatter here, and for the big nets every value choice
    the one lookup (the small net's are in the module docstring)."""

    total_steps: int = 200_000_000  # env steps (board-moves) to train for
    n_envs: int = 4096
    alpha: float = 0.1          # value-space learning rate
    alpha_final: float = 0.02   # linear anneal target over total_steps
    init_value: float = 80_000.0  # optimistic initial value of a board
    seed: int = 0
    chunk_steps: int = 256      # steps per train_chunk call
    update_impl: str = "auto"   # auto / scatter / mxu / rows
    value_impl: str = "auto"    # auto / gather / mxu / mxu_bf16 / rows
    # temporal-coherence learning (Beal & Smith): per-entry adaptive rates
    # |sum(deltas)| / sum(|deltas|); set alpha = alpha_final = 1.0
    tc: bool = False
    # "small" (the 17x4-cell net of models/ntuple.py) or a layout of
    # models/ntuple_big.LAYOUTS
    arch: str = "small"
    n_vals: int = 16            # exponent domain per cell of the big nets
    thresholds: tuple[int, ...] = ()  # max-tile-exponent stage boundaries
    # delayed TC: the table-sized TC combine every k steps; chunk_steps
    # must divide into windows of k
    tc_every: int = 1
    # probability that a finished env restarts from a recorded stage-entry
    # board (staged nets only); 0 = off
    carousel: float = 0.0
    carousel_slots: int = 256   # stage-entry reservoir slots per stage


def _greedy_batch(value_fn, boards: torch.Tensor):
    """Greedy afterstate move of ``(B, 4, 4)`` boards, all ``4 B`` candidate
    afterstates valued in one ``value_fn((N, 4, 4)) -> (N,)`` call.

    Returns ``(action (B,) int32, afterstate (B, 4, 4), reward (B,) f32,
    v_after (B,) f32, any_legal (B,) bool)``. A board with no legal move
    takes action 0 (argmax over all ``-inf`` is the first index, as in JAX).
    """
    b = boards.shape[0]
    moved, scores, legal = rules.move_all(boards)
    vals = value_fn(moved.reshape(b * 4, 4, 4)).reshape(b, 4)
    q = torch.where(legal, scores.to(torch.float32) + vals, -torch.inf)
    a = q.argmax(-1)
    col = a[:, None]
    after = moved.gather(1, col[:, :, None, None].expand(b, 1, 4, 4))[:, 0]
    r = scores.gather(1, col)[:, 0].to(torch.float32)
    # a masked sum, as JAX takes it: a -0.0 value comes out +0.0
    sel = torch.arange(4, device=boards.device) == col
    v_after = torch.where(sel, vals, 0.0).sum(-1)
    return a.to(torch.int32), after, r, v_after, legal.any(-1)


def _carousel_record(car_b, car_f, st_prev, st_next, alive, next_state, u_slot):
    """Record stage-entry boards in the per-stage reservoir: an env whose
    post-spawn ``next_state`` entered a higher stage than its pre-move
    board writes it into slot ``trunc(u_slot * slots)`` of its new stage's
    row (random replacement). The other envs write into row 0, which is
    never sampled, so the write needs no mask. Where two envs write one
    slot, which one stays is undefined (as in JAX). Returns new
    ``(car_b, car_f)``."""
    r = car_b.shape[1]
    crossed = (st_next > st_prev) & alive
    slot = (u_slot * r).to(torch.int64)
    s_idx = torch.where(crossed, st_next, 0).to(torch.int64)
    car_b = car_b.index_put((s_idx, slot), next_state)
    car_f = car_f.index_put((s_idx, slot), torch.ones((), dtype=torch.bool,
                                                      device=car_f.device))
    return car_b, car_f


def _carousel_restart(car_b, car_f, fresh, u_use, u_stage, u_pick, p):
    """Restart boards ``(B, 4, 4)`` for finished envs: where ``u_use < p`` and
    the drawn slot (stage ``1 + trunc(u_stage * (stages - 1))``, slot
    ``trunc(u_pick * slots)``) is filled, that recorded board; otherwise
    ``fresh``."""
    s, r = car_f.shape
    use = u_use < p
    s_pick = 1 + (u_stage * (s - 1)).to(torch.int64)
    j_pick = (u_pick * r).to(torch.int64)
    ok = use & car_f[s_pick, j_pick]
    return torch.where(ok[:, None, None], car_b[s_pick, j_pick], fresh)


@dataclasses.dataclass
class TDLogEntry:
    steps: int
    episodes: float
    ep_score_mean: float
    highest_tile_max: int
    alpha: float
    wall: float


class TDTrainer:
    """Batched TD(0) afterstate trainer of an n-tuple network on ``device``
    (the card unless the caller passes ``"cpu"``). ``_net`` is the big
    network, None for the small net (as in JAX), whose value mode is
    ``_small``. The JAX trainer's assertions raise ``ValueError``."""

    def __init__(self, config: TDConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg = config or TDConfig()
        self.device = torch.device(device)
        self._net = self._small = None
        if cfg.arch == "small":
            if cfg.tc_every != 1 or cfg.carousel:
                raise ValueError("tc_every/carousel are big-net staged-training features")
            if cfg.thresholds:
                raise ValueError("staged training is configured via promote_table for the "
                                 "small net; thresholds apply to big-net archs")
            if cfg.update_impl not in ("auto", "scatter", "mxu"):
                raise ValueError(f"the small net's update_impl is auto, scatter or mxu, "
                                 f"got {cfg.update_impl!r}")
            self._small = ntuple.SmallNet(cfg.value_impl)
            return
        vimpl = "gather" if cfg.value_impl in ("auto", "mxu", "mxu_bf16") else cfg.value_impl
        uimpl = "scatter" if cfg.update_impl in ("auto", "mxu") else cfg.update_impl
        self._net = ntuple_big.make_network(cfg.arch, cfg.n_vals, cfg.thresholds,
                                            value_impl=vimpl, update_impl=uimpl)
        if cfg.tc_every != 1:
            if not (cfg.tc and cfg.tc_every > 1):
                raise ValueError("tc_every requires tc=True and a value > 1")
            if cfg.chunk_steps % cfg.tc_every:
                raise ValueError(f"chunk_steps {cfg.chunk_steps} must divide into "
                                 f"tc_every {cfg.tc_every} windows")
            if self._net.update_impl != "scatter":
                raise ValueError("delayed TC accumulates via the scatter update path")
        if cfg.carousel:
            if not cfg.thresholds:
                raise ValueError("carousel shaping restarts from stage-entry states: "
                                 "configure multi-stage thresholds")
            if not 0.0 < cfg.carousel <= 1.0:
                raise ValueError(f"carousel must lie in (0, 1], got {cfg.carousel}")

    def init_state(self, generator: torch.Generator | None = None) -> dict:
        """A fresh train state on the trainer's device: the table at
        ``init_value``, fresh boards, zero accumulators and reservoirs, and
        the generator (seeded from ``cfg.seed`` unless given)."""
        cfg, dev = self.cfg, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        if self._net is not None:
            table = self._net.init_table(cfg.init_value, device=dev)
        else:  # per entry x gives value(board) = 136 x / 8 = 17 x
            table = ntuple.init_table(cfg.init_value / ntuple.N_TUPLES, device=dev)
        boards = _fresh_boards(torch.rand((cfg.n_envs, 4), generator=generator, device=dev))
        state = {
            "table": table,
            "boards": boards,
            "score": torch.zeros(cfg.n_envs, dtype=torch.float32, device=dev),
            # the previous step's chosen afterstate, its value when chosen,
            # and whether it still awaits its TD target
            "prev_after": torch.zeros_like(boards),
            "prev_v": torch.zeros(cfg.n_envs, dtype=torch.float32, device=dev),
            "prev_valid": torch.zeros(cfg.n_envs, dtype=torch.bool, device=dev),
            "generator": generator,
        }
        if cfg.tc:
            state["tc_e"] = torch.zeros_like(table)
            state["tc_a"] = torch.zeros_like(table)
        if cfg.carousel:
            s = self._net.n_stages
            state["car_boards"] = torch.zeros((s, cfg.carousel_slots, 4, 4),
                                              dtype=boards.dtype, device=dev)
            state["car_filled"] = torch.zeros((s, cfg.carousel_slots), dtype=torch.bool,
                                              device=dev)
        return state

    def _draws(self, generator: torch.Generator, n: int) -> dict:
        """One step's uniforms for ``n`` envs, in one draw: the spawn's value
        and position ``(n,)`` each, the fresh boards' ``(n, 4)``, and with
        the carousel its record slot and its use, stage and slot draws."""
        rows = 10 if self.cfg.carousel else 6
        u = torch.rand((rows, n), generator=generator, device=generator.device)
        draws = {"spawn_val": u[0], "spawn_pos": u[1], "fresh": u[2:6].T}
        if self.cfg.carousel:
            draws.update(car_slot=u[6], car_use=u[7], car_stage=u[8], car_pick=u[9])
        return draws

    def _chunk_body(self, alpha, defer_tc: bool = False):
        """The step: ``body(carry, draws) -> (carry, (n_done, done_score,
        highest))``, with ``draws`` as :meth:`_draws` returns them.

        ``defer_tc``: scatter-accumulate the TC statistics into the carried
        ``tc_ps`` / ``tc_pa`` / ``tc_pc`` buffers instead of applying the
        table-sized combine (the inner step of delayed TC)."""
        cfg, net = self.cfg, self._net
        if net is not None:
            values, update_td, update_tc = net, net.td_update, net.td_update_tc
        else:
            values, update_td, update_tc = self._small, ntuple.td_update, ntuple.td_update_tc

        def body(carry: dict, draws: dict):
            table, boards, score = carry["table"], carry["boards"], carry["score"]
            # the small net's "mxu" modes split the table once a step, as in JAX
            value_fn = values.make_value_fn(table)
            _, after, r, v_after, alive = _greedy_batch(value_fn, boards)

            # TD update of the PREVIOUS afterstate, whose successor is
            # `boards`: target r + V(after) if a move exists, else 0.
            # prev_valid masks just-reset envs out of deltas and counts.
            target = torch.where(alive, r + v_after, 0.0)
            delta = target - carry["prev_v"]
            new = dict(carry)
            if cfg.tc and defer_tc:
                pending = tuple(carry[p] for p in _PENDING)
                new.update(zip(_PENDING, net.tc_accumulate(
                    pending, carry["prev_after"], delta, valid=carry["prev_valid"])))
            elif cfg.tc:
                new["table"], new["tc_e"], new["tc_a"] = update_tc(
                    table, carry["tc_e"], carry["tc_a"], carry["prev_after"], delta,
                    alpha, valid=carry["prev_valid"])
            else:
                new["table"] = update_td(table, carry["prev_after"], delta, alpha,
                                         valid=carry["prev_valid"])

            next_state = rules.spawn(after, draws["spawn_val"], draws["spawn_pos"])

            # episode bookkeeping: a board resets when it has no legal move
            score = score + torch.where(alive, r, 0.0)
            done = ~alive
            n_done = done.sum().to(torch.float32)
            done_score = torch.where(done, score, 0.0).sum()
            highest = boards.max()

            fresh = _fresh_boards(draws["fresh"])
            if cfg.carousel:
                car_b, car_f = _carousel_record(
                    carry["car_boards"], carry["car_filled"],
                    stage_of_batch(boards, net.thresholds),
                    stage_of_batch(next_state, net.thresholds),
                    alive, next_state, draws["car_slot"])
                fresh = _carousel_restart(car_b, car_f, fresh, draws["car_use"],
                                          draws["car_stage"], draws["car_pick"],
                                          cfg.carousel)
                new["car_boards"], new["car_filled"] = car_b, car_f
            new["boards"] = torch.where(done[:, None, None], fresh, next_state)
            new["score"] = torch.where(done, 0.0, score)
            new["prev_after"] = after
            new["prev_v"] = v_after
            new["prev_valid"] = alive
            return new, (n_done, done_score, highest)

        return body

    def _scan_steps(self, carry: dict, alpha, length: int):
        """``length`` steps, each with its draws from the carry's generator.
        With ``cfg.tc_every > 1`` (delayed TC) the TC statistics accumulate
        in table-sized pending buffers that live only inside this call, and
        the combine runs at the end of every window of ``tc_every`` steps.
        Returns the carry and the per-step stats stacked ``(length,)``."""
        cfg = self.cfg
        gen = carry["generator"]
        n = carry["boards"].shape[0]
        stats = []
        if not (cfg.tc and cfg.tc_every > 1):
            body = self._chunk_body(alpha)
            for _ in range(length):
                carry, s = body(carry, self._draws(gen, n))
                stats.append(s)
        else:
            k = cfg.tc_every
            if length % k:
                raise ValueError(f"{length} steps do not divide into windows of {k}")
            body = self._chunk_body(alpha, defer_tc=True)
            carry = dict(carry)
            carry.update((p, torch.zeros_like(carry["table"])) for p in _PENDING)
            for _ in range(length // k):
                for _ in range(k):
                    carry, s = body(carry, self._draws(gen, n))
                    stats.append(s)
                carry = dict(carry)
                carry["table"], carry["tc_e"], carry["tc_a"] = _tc_combine(
                    carry["table"], carry["tc_e"], carry["tc_a"],
                    *(carry[p] for p in _PENDING), alpha)
                for p in _PENDING:
                    carry[p].zero_()
            for p in _PENDING:
                del carry[p]
        return carry, tuple(torch.stack(s) for s in zip(*stats))

    def train_chunk(self, state: dict, alpha):
        """``cfg.chunk_steps`` TD steps over all envs; returns ``(state,
        metrics)`` with the metrics as device tensors (no host sync).

        One greedy search per step: the target of step t-1's afterstate is
        assembled from step t's greedy result, so each board is searched
        once per move. The returned state is new, except its generator,
        which is the given state's and has advanced (JAX donates the
        state)."""
        alpha = torch.as_tensor(alpha, dtype=torch.float32)
        new_state, (n_done, done_score, highest) = self._scan_steps(
            dict(state), alpha, self.cfg.chunk_steps)
        episodes = n_done.sum()
        metrics = {
            "episodes": episodes,
            "ep_score_mean": done_score.sum() / episodes.clamp(min=1.0),
            "highest_exp": highest.max().to(torch.int32),
        }
        return new_state, metrics

    def make_sharded_chunk(self, mesh):
        raise NotImplementedError(SHARDED_NOT_PORTED)

    def learn(self, state: dict | None = None, log_every: int = 50, log_fn=print,
              ckpt_path=None, ckpt_every: int = 0, start_chunk: int = 0,
              max_chunks: int | None = None, mesh=None):
        """Run training; the step count rounds UP to whole chunks of
        ``n_envs * chunk_steps``. ``ckpt_path`` + ``ckpt_every`` (chunks)
        save the whole train state with :func:`save_train_state`, so a run
        resumes bit-continuously from it (pass the loaded state and
        ``start_chunk``; alpha's schedule follows from the chunk counter).
        ``max_chunks`` bounds the chunks of this call. Returns ``(state,
        history)``."""
        if mesh is not None:
            raise NotImplementedError(SHARDED_NOT_PORTED)
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        steps_per_chunk = cfg.n_envs * cfg.chunk_steps
        n_chunks = -(-cfg.total_steps // steps_per_chunk)  # ceil
        if log_fn is not None and n_chunks * steps_per_chunk != cfg.total_steps:
            log_fn(f"total_steps {cfg.total_steps} rounded up to "
                   f"{n_chunks * steps_per_chunk} ({n_chunks} chunks of {steps_per_chunk})")
        t0 = time.perf_counter()
        history = []
        stop = n_chunks if max_chunks is None else min(n_chunks, start_chunk + max_chunks)
        for c in range(start_chunk, stop):
            frac = c / max(n_chunks - 1, 1)
            alpha = cfg.alpha + (cfg.alpha_final - cfg.alpha) * frac
            state, metrics = self.train_chunk(state, alpha)
            if ckpt_path and ckpt_every and ((c + 1) % ckpt_every == 0 or c + 1 == stop):
                save_train_state(ckpt_path, state, cfg, chunks_done=c + 1)
            if (c + 1) % log_every == 0 or c + 1 == stop:
                m = {k: float(v) for k, v in metrics.items()}  # the host sync
                entry = TDLogEntry(
                    steps=(c + 1) * steps_per_chunk,
                    episodes=m["episodes"],
                    ep_score_mean=m["ep_score_mean"],
                    highest_tile_max=int(2 ** m["highest_exp"]),
                    alpha=alpha,
                    wall=time.perf_counter() - t0,
                )
                history.append(entry)
                if log_fn is not None:
                    run_steps = (c + 1 - start_chunk) * steps_per_chunk
                    log_fn(f"steps {entry.steps} ep_score {entry.ep_score_mean:.0f} "
                           f"highest {entry.highest_tile_max} alpha {alpha:.3f} "
                           f"({run_steps / entry.wall / 1e3:.0f}k steps/s)")
        return state, history


def shard_td_state(state: dict, mesh) -> dict:
    raise NotImplementedError(SHARDED_NOT_PORTED)


TRAIN_STATE_FORMAT = "td_train_state_v1"


def save_train_state(path, state: dict, cfg: TDConfig, chunks_done: int) -> None:
    """Write the whole train state (table, TC accumulators, env batch,
    delayed-update carry, reservoirs) with the chunk counter, atomically,
    in the JAX package's layout. The generator's state, which the JAX
    file's PRNG key stands for, is saved under ``"generator_state"``."""
    variables = {k: v for k, v in state.items() if k != "generator"}
    variables["generator_state"] = state["generator"].get_state()
    tmp = str(path) + ".tmp"
    save_model(tmp, variables, meta={"format": TRAIN_STATE_FORMAT,
                                     "config": dataclasses.asdict(cfg),
                                     "chunks_done": int(chunks_done)})
    os.replace(tmp, path)


def resume_seed(seed: int, chunks_done: int) -> int:
    """The generator seed of a state resumed at ``chunks_done`` without a
    saved generator state: ``seed`` itself at chunk 0, as a fresh state."""
    return (int(seed) + (int(chunks_done) << 32)) % 2 ** 64


def load_train_state(path, device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """Load a :func:`save_train_state` file -> ``(state, meta)`` on ``device``.

    A file written by the JAX package's ``save_train_state`` loads too. It
    holds a PRNG key and no generator state: the key is dropped, and the
    generator is seeded with ``resume_seed(config seed, chunks_done)``, so
    the resumed run is reproducible but does not continue JAX's random
    stream. A saved generator state restores only on the device type it was
    saved from. Raises on a file that is not a train state."""
    variables, meta = load_model(path)
    if meta.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(f"{path} is not a TD train-state checkpoint (meta keys "
                         f"{sorted(meta)})")
    generator = torch.Generator(device=device)
    if "generator_state" in variables:
        generator.set_state(torch.from_numpy(np.asarray(variables["generator_state"])))
    else:
        generator.manual_seed(resume_seed(meta["config"]["seed"], meta["chunks_done"]))
    return interop.train_state_from_numpy(variables, device, generator=generator), meta


def is_train_state(path) -> bool:
    """True when ``path`` holds a train-state checkpoint (not a bare table
    pickle, not an unreadable file)."""
    try:
        _, meta = load_model(path)
    except (OSError, EOFError, pickle.UnpicklingError, KeyError, TypeError):
        return False
    return isinstance(meta, dict) and meta.get("format") == TRAIN_STATE_FORMAT


def play_greedy(table: torch.Tensor, episodes: int,
                generator: torch.Generator | None = None, move_cap: int = 30000,
                value_impl: str = "auto", net=None) -> dict:
    """Play ``episodes`` full games with the greedy afterstate policy over
    ``table``, on the table's device (evaluation): of the big network
    ``net``, or without ``net`` of the small net read by ``value_impl``
    (``"auto"`` is the exact ``"gather"``; ignored when ``net`` is given,
    as in JAX). The host checks whether any game is live every 64 moves
    (JAX's loop runs on the device); moves past the end change nothing."""
    dev = table.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    value_fn = (net if net is not None else ntuple.SmallNet(value_impl)).make_value_fn(table)
    boards = _fresh_boards(torch.rand((episodes, 4), generator=generator, device=dev))
    total = torch.zeros(episodes, dtype=torch.float32, device=dev)
    moves = torch.zeros(episodes, dtype=torch.int32, device=dev)
    high = torch.zeros(episodes, dtype=torch.int32, device=dev)
    active = torch.ones(episodes, dtype=torch.bool, device=dev)
    t = 0
    while t < move_cap and bool(active.any()):
        for _ in range(min(_SYNC_EVERY, move_cap - t)):
            u = torch.rand((2, episodes), generator=generator, device=dev)
            _, after, r, _, alive = _greedy_batch(value_fn, boards)
            nxt = rules.spawn(after, u[0], u[1])
            step_live = active & alive
            total += torch.where(step_live, r, 0.0)
            moves += step_live.to(torch.int32)
            high = torch.maximum(high, torch.where(
                step_live, nxt.flatten(-2).amax(-1), 0).to(torch.int32))
            boards = torch.where(step_live[:, None, None], nxt, boards)
            active = step_live
            t += 1
    total, moves, high = total.cpu().numpy(), moves.cpu().numpy(), high.cpu().numpy()
    return {
        "Average score": float(total.mean()),
        "Max score": float(total.max()),
        "Highest tile": int(2 ** high.max()) if high.max() > 0 else 0,
        "Episodes": [
            {"total_reward": float(total[i]),
             "highest": int(2 ** high[i]) if high[i] > 0 else 0,
             "moves": int(moves[i])}
            for i in range(episodes)
        ],
    }


def main(argv: list[str] | None = None) -> None:
    import argparse
    import collections
    import json

    p = argparse.ArgumentParser(
        description="TD(0) afterstate training of an n-tuple network (PyTorch).")
    p.add_argument("--steps", type=int, default=TDConfig.total_steps)
    p.add_argument("--envs", type=int, default=TDConfig.n_envs)
    p.add_argument("--alpha", type=float, default=TDConfig.alpha)
    p.add_argument("--alpha-final", type=float, default=TDConfig.alpha_final)
    p.add_argument("--init-value", type=float, default=TDConfig.init_value)
    p.add_argument("--chunk-steps", type=int, default=TDConfig.chunk_steps,
                   help="steps per chunk; total steps round up to whole chunks of "
                   "envs*chunk_steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--update-impl", choices=("auto", "scatter", "mxu", "rows"),
                   default="auto",
                   help="the JAX package's table update paths (mxu: small net, rows: "
                   "big nets); all are the one scatter here")
    p.add_argument("--value-impl", choices=("auto", "gather", "mxu", "mxu_bf16", "rows"),
                   default="auto",
                   help="the small net's lookups: gather (auto; exact), mxu (the bf16 "
                   "split halves, ~2**-16), mxu_bf16 (the hi half, ~0.4%%); for the big "
                   "nets every choice is the one lookup kernel")
    p.add_argument("--arch", default="small",
                   help='"small" (the 17x4-cell net) or a layout of '
                   "models/ntuple_big.LAYOUTS (4x6, 5x6, 4x6_4x4)")
    p.add_argument("--n-vals", type=int, default=TDConfig.n_vals,
                   help="exponent domain per cell (clip above)")
    p.add_argument("--thresholds", type=int, nargs="*", default=[],
                   help="multi-stage max-tile exponent thresholds, e.g. 11 12")
    p.add_argument("--tc-every", type=int, default=TDConfig.tc_every,
                   help="delayed TC (arXiv:1604.05085): apply the TC combine every k "
                   "steps (TC only; must divide --chunk-steps)")
    p.add_argument("--carousel", type=float, default=TDConfig.carousel,
                   help="carousel shaping (arXiv:1604.05085): probability that a "
                   "finished env restarts from a recorded stage-entry board (staged "
                   "nets only; 0 = off)")
    p.add_argument("--carousel-slots", type=int, default=TDConfig.carousel_slots,
                   help="stage-entry reservoir slots per stage")
    p.add_argument("--tc", action="store_true",
                   help="temporal-coherence per-entry adaptive rates (set --alpha and "
                   "--alpha-final to the meta-rate, typically 1.0)")
    p.add_argument("--eval-episodes", type=int, default=128)
    p.add_argument("--output", default="ntuple_table.pkl")
    p.add_argument("--resume", default=None,
                   help="a --ckpt train-state file resumes the whole state (also one "
                   "written by the JAX package); a bare table .pkl seeds the table")
    p.add_argument("--ckpt", default=None,
                   help="path for periodic whole train-state checkpoints (atomic "
                   "overwrite; resumable with --resume)")
    p.add_argument("--ckpt-every", type=int, default=50, help="chunks between --ckpt saves")
    p.add_argument("--sharded", action="store_true",
                   help="data-parallel training (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for the plain path)")
    args = p.parse_args(argv)
    if args.arch == "small" and "rows" in (args.update_impl, args.value_impl):
        p.error('--update-impl/--value-impl "rows" applies to the big-net architectures '
                'only (--arch 4x6/5x6/4x6_4x4); the small net supports auto/scatter/mxu '
                'updates and auto/gather/mxu/mxu_bf16 values')
    if args.sharded:
        p.error(SHARDED_NOT_PORTED)

    cfg = TDConfig(
        total_steps=args.steps, n_envs=args.envs, alpha=args.alpha,
        alpha_final=args.alpha_final, init_value=args.init_value,
        seed=args.seed, chunk_steps=args.chunk_steps,
        update_impl=args.update_impl, value_impl=args.value_impl,
        tc=args.tc, arch=args.arch, n_vals=args.n_vals,
        thresholds=tuple(args.thresholds), tc_every=args.tc_every,
        carousel=args.carousel, carousel_slots=args.carousel_slots,
    )
    trainer = TDTrainer(cfg, device=args.device)
    state = trainer.init_state()
    start_chunk = 0
    if args.resume:
        if is_train_state(args.resume):
            state, meta = load_train_state(args.resume, device=args.device)
            start_chunk = meta["chunks_done"]
            print(f"resumed full train state at chunk {start_chunk} "
                  f"({start_chunk * cfg.n_envs * cfg.chunk_steps} steps)")
        else:
            variables, _ = load_model(args.resume)
            state["table"] = interop.table_from_numpy(variables["table"], args.device)
    state, history = trainer.learn(state, ckpt_path=args.ckpt, ckpt_every=args.ckpt_every,
                                   start_chunk=start_chunk)
    save_model(args.output, {"table": state["table"]},
               meta={"config": dataclasses.asdict(cfg)})

    ev = play_greedy(state["table"], args.eval_episodes,
                     torch.Generator(device=args.device).manual_seed(args.seed + 1),
                     net=trainer._net)
    dist = collections.Counter(e["highest"] for e in ev["Episodes"])
    print(json.dumps({
        "steps": history[-1].steps if history else 0,
        "requested_steps": args.steps,
        "Average score": ev["Average score"],
        "Max score": ev["Max score"],
        "Highest tile": ev["Highest tile"],
        "tile_distribution": dict(sorted(dist.items())),
        "output": args.output,
    }))


if __name__ == "__main__":
    main()
