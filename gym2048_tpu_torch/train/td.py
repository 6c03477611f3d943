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
nets also delayed TC (``tc_every``: the TC combine once per window of
steps, the statistics scatter-accumulated in between), staged tables
(``thresholds``) and carousel restarts (``carousel``: finished games
restart from recorded stage-entry boards), all from arXiv:1604.05085.
Where JAX combines the whole table, the port combines the entries that the
window's steps touched, whose flat indices each step records
(``ntuple.tc_combine_at``: one CUDA kernel launch on the card), with the
same result bit for bit.

The small net's value modes are the JAX package's: ``"gather"`` (the exact
lookup; ``"auto"`` here, as in JAX off the TPU), ``"mxu"`` (two lookups into
the bf16 split halves of the table, split once a step) and ``"mxu_bf16"``
(the ``hi`` half alone). Its ``update_impl`` ``"mxu"`` names a matmul form
of the scatter for the TPU with the scatter's sums; every choice runs the
scatter here.

Randomness: one ``torch.Generator`` on the trainer's device, seeded from
``TDConfig.seed``, takes the place of the JAX key. It is carried in the
train state under ``"generator"`` and advances as the state is trained.
Each step draws its uniforms in one call (:meth:`TDTrainer._draws`) into a
buffer, so a test can feed the step the numbers JAX drew. The steps of a
chunk are a Python loop with no host sync (:meth:`TDTrainer._scan_steps`);
:meth:`TDTrainer.learn` syncs once per logged chunk. On every device each
step's greedy search runs in a :class:`_GreedySearch` and its tail,
everything after the search but an update that writes the table, on the
static buffers of a :class:`_StepTail`: two CUDA graph replays on the card,
plain calls of the same code elsewhere. The search's graph reads the table
at one address, so every write of the table during a chunk (the delayed-TC
combine, the update without delayed TC) lands in that tensor in place.

Data parallel (:meth:`TDTrainer.make_sharded_chunk`, ``learn(mesh=...)``,
``--sharded``): chunk-synchronous local learners over the ``data`` axis of
a :mod:`gym2048_tpu_torch.parallel` mesh, one table merge per chunk, as in
JAX; see :class:`ShardedChunk`.

Run: ``python -m gym2048_tpu_torch.train.td`` (the small net) or ``--arch
4x6 --tc --alpha 1 --alpha-final 1 --init-value 0`` on the card, ``--device
cpu`` on the CPU; data parallel over N ranks with ``torchrun --standalone
--nproc-per-node N -m gym2048_tpu_torch.train.td --sharded ...``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import pickle
import time

import numpy as np
import torch

from gym2048_tpu_torch import interop
from gym2048_tpu_torch.core import rules
from gym2048_tpu_torch.env.batched import _fresh_boards
from gym2048_tpu_torch.models import ntuple, ntuple_big
from gym2048_tpu_torch.models.ntuple import stage_of_batch, tc_combine_at
from gym2048_tpu_torch.parallel import mesh as pmesh
from gym2048_tpu_torch.utils import graphs, profiler
from gym2048_tpu_torch.utils.checkpoint import load_model, save_model

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
    with profiler.span("td.greedy"):
        b = boards.shape[0]
        moved, scores, legal = rules.move_all(boards)
        with profiler.span("td.lookup"):
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


def _split_draws(u: torch.Tensor) -> dict:
    """:meth:`TDTrainer._draws`' dict of views of its ``(rows, n)`` draw
    (10 rows with the carousel, else 6)."""
    draws = {"spawn_val": u[0], "spawn_pos": u[1], "fresh": u[2:6].T}
    if u.shape[0] == 10:
        draws.update(car_slot=u[6], car_use=u[7], car_stage=u[8], car_pick=u[9])
    return draws


class _StepTail:
    """A TD step after its greedy search, on static buffers, the tail of
    every step that :meth:`TDTrainer._scan_steps` runs: with delayed TC the
    update (the TD error and the scatter-accumulate into the pending sums),
    then the episode bookkeeping, the spawn, the fresh boards, the carousel
    and the reset, the step's leaves written into :attr:`carry` and its
    stats into row ``step`` of :attr:`stats`. On a CUDA device each
    :meth:`replay` after the first :data:`graphs.WARMUP` (eager, on a side
    stream, as real steps) launches one CUDA graph of it, captured at the
    first (:class:`graphs.GraphedStep`); elsewhere every replay is a plain
    call of the same code.

    The buffers: :attr:`u`, the step's draw (:meth:`TDTrainer._draws`
    writes it); :attr:`carry`, the step's leaves, the table and, with
    delayed TC, the pending sums, which stay zero between windows (the
    combine zeroes them where it combines); with delayed TC
    :attr:`window_idx`, the ``window`` shape ``(k, B * features)`` int32
    record of the window's flat occurrence indices, each step's in row
    ``step % k`` (:meth:`NTupleNetwork.tc_accumulate`), which the combine
    reads; :attr:`stats`, ``(n_done, done_score, highest)`` of each step.
    The inputs ``after``, ``r``, ``v_after``, ``alive`` are the greedy
    search's results where they lie (:attr:`inputs`, copied nowhere): on
    the card the outputs of the search's graph, the same tensors at every
    replay. The graph reads no host scalar and not the table, which the
    search's graph reads and the combine (and the update without delayed
    TC, which stays outside) writes in place."""

    def __init__(self, carry: dict, length: int, update, restart,
                 window: tuple[int, int] | None = None):
        boards = carry["boards"]
        dev, n = boards.device, boards.shape[0]
        self.key = self.key_of(carry, length)
        self.update, self.restart = update, restart
        self.carry = {k: torch.zeros_like(carry[k]) for k in _TAIL_KEYS & carry.keys()}
        self.u = torch.zeros((10 if "car_boards" in carry else 6, n), device=dev)
        self.draws = _split_draws(self.u)
        self.inputs = None  # the greedy search's (after, r, v_after, alive)
        self.stats = (torch.zeros(length, device=dev), torch.zeros(length, device=dev),
                      torch.zeros(length, dtype=boards.dtype, device=dev))
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.window_idx = self.record = None
        if update is not None:  # delayed TC
            self.carry.update((p, torch.zeros_like(carry["table"])) for p in _PENDING)
            self.window_idx = torch.zeros(window, dtype=torch.int32, device=dev)
            self.record = (self.window_idx, self.step)
        self.dirty = False  # pending sums left by a scan that did not end
        self.graphed = graphs.GraphedStep(self._run, "td.tail_replays", dev)

    @staticmethod
    def key_of(carry: dict, length: int) -> tuple:
        """What a tail is built for: the carry's device, envs and leaves,
        the table's size, the step count and torch's kernel flags (read at
        capture)."""
        return (carry["boards"].device, carry["boards"].shape[0], carry["table"].numel(),
                length, tuple(sorted(_STEP_KEYS & carry.keys())), graphs.kernel_flags())

    def _run(self) -> None:
        """The tail once, on the buffers (what the graph holds)."""
        after, r, v_after, alive = self.inputs
        new = dict(self.carry)
        if self.update is not None:
            self.update(self.carry, new, r, v_after, alive, self.record)
        stats = self.restart(self.carry, new, self.draws, after, r, v_after, alive)
        for k, buf in self.carry.items():
            if new[k] is not buf:
                buf.copy_(new[k])
        for buf, s in zip(self.stats, stats):
            buf.index_copy_(0, self.step, s.reshape(1))
        self.step.add_(1)

    def load(self, carry: dict) -> dict:
        """Copy ``carry``'s step leaves and table into the buffers for a
        scan; returns the buffers (the pending sums among them)."""
        for k, buf in self.carry.items():
            if k in _PENDING:
                if self.dirty:
                    buf.zero_()
            else:
                buf.copy_(carry[k])
        self.step.zero_()
        self.dirty = True
        return self.carry

    def replay(self, inputs: tuple) -> None:
        """One step's tail on the greedy search's results ``(after, r,
        v_after, alive)``, read where they lie, in the span ``td.tail``
        where the tail captures a graph (on the card). A captured graph
        reads the tensors it was captured on: the search's graph writes
        them at every replay."""
        if self.graphed.graph is not None and any(
                a is not b for a, b in zip(inputs, self.inputs)):
            raise RuntimeError("the tail's graph reads other tensors than these inputs")
        self.inputs = inputs
        with profiler.span("td.tail") if self.graphed.captures else contextlib.nullcontext():
            if self.graphed.warming:
                self.graphed.eager(self._run)
            else:
                self.graphed.replay()

    def unload(self, state: dict) -> tuple[dict, tuple]:
        """The scan's result: ``state`` with copies of the step leaves and
        the table in place of the buffers and without the pending sums,
        and copies of the stats, so that the next scan's replays change
        neither."""
        self.dirty = False
        out = {k: v for k, v in state.items() if k not in _PENDING}
        out.update((k, buf.clone()) for k, buf in self.carry.items() if k not in _PENDING)
        return out, tuple(s.clone() for s in self.stats)


class _GreedySearch:
    """The greedy search of every step that :meth:`TDTrainer._scan_steps`
    runs, on a :class:`_StepTail`'s buffers: :func:`_greedy_batch` of its
    ``boards`` valued on its ``table`` (``rules.move_all``, the feature
    indices, the lookup, the sum over symmetries, the argmax, the chosen
    afterstate's gathers), its results in :attr:`out`, which the tail
    reads. On a CUDA device each :meth:`replay` after the first
    :data:`graphs.WARMUP` launches one CUDA graph of it, in the span
    ``td.greedy`` (the warm-ups and the capture open theirs in
    :func:`_greedy_batch`); its outputs are then the same tensors at every
    replay. Elsewhere every replay is a plain call of the same code, which
    calls :func:`_greedy_batch` and the network's lookup through their
    modules. Built for one tail: it is keyed by the tail's key and the
    identity of the table buffer."""

    def __init__(self, values, tail: _StepTail):
        self.values, self.key = values, tail.key
        self.table, self.boards = tail.carry["table"], tail.carry["boards"]
        self.out = None
        self.graphed = graphs.GraphedStep(self._run, "td.greedy_replays", self.boards.device,
                                          span="td.greedy")

    def fits(self, tail: _StepTail) -> bool:
        """Whether this search was built for ``tail`` and its table."""
        return self.key == tail.key and self.table is tail.carry["table"]

    def _run(self) -> None:
        """The search once, on the buffers (what the graph holds)."""
        self.out = _greedy_batch(self.values.make_value_fn(self.table), self.boards)[1:]

    def replay(self) -> tuple:
        """One step's search -> ``(after, r, v_after, alive)``."""
        if self.graphed.warming:
            self.graphed.eager(self._run)
        else:
            self.graphed.replay()
        return self.out


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
        self.chunks = 0  # train_chunk calls: the unit id of their spans
        self._net = self._small = None
        self._tail = self._greedy = None  # the _StepTail and _GreedySearch of _scan_steps
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

    @staticmethod
    def _draws(generator: torch.Generator, out: torch.Tensor) -> dict:
        """One step's uniforms for ``n`` envs, in one draw into ``out``, a
        ``(rows, n)`` buffer (10 rows with the carousel, else 6): the
        spawn's value and position ``(n,)`` each, the fresh boards' ``(n,
        4)``, and with the carousel its record slot and its use, stage and
        slot draws."""
        return _split_draws(torch.rand(out.shape, generator=generator,
                                       device=generator.device, out=out))

    def _update(self, alpha, defer_tc: bool):
        """The step's TD update: ``update(carry, new, r, v_after, alive,
        record=None)`` writes into ``new`` the table (in place: ``new``'s
        table is ``carry``'s) and new ``tc_e``, ``tc_a``, or with
        ``defer_tc`` the pending sums (in place), that the update of
        ``carry``'s previous afterstate gives; with ``record``, a
        :class:`_StepTail`'s ``(window_idx, step)``, the step's flat
        occurrence indices go into the window's record too. The function
        holds the config and the network, not the trainer, which a
        :class:`_StepTail` that keeps it would keep alive."""
        cfg, net = self.cfg, self._net
        if net is not None:
            update_td, update_tc = net.td_update, net.td_update_tc
        else:
            update_td, update_tc = ntuple.td_update, ntuple.td_update_tc

        def update(carry: dict, new: dict, r, v_after, alive, record=None) -> None:
            # TD update of the PREVIOUS afterstate, whose successor is the
            # searched boards: target r + V(after) if a move exists, else 0.
            # prev_valid masks just-reset envs out of deltas and counts.
            with profiler.span("td.update"):
                target = torch.where(alive, r + v_after, 0.0)
                delta = target - carry["prev_v"]
                if cfg.tc and defer_tc:
                    pending = tuple(carry[p] for p in _PENDING)
                    if record is not None:
                        pending += (record,)
                    new.update(zip(_PENDING, net.tc_accumulate(
                        pending, carry["prev_after"], delta, valid=carry["prev_valid"])))
                elif cfg.tc:
                    new["table"], new["tc_e"], new["tc_a"] = update_tc(
                        carry["table"], carry["tc_e"], carry["tc_a"], carry["prev_after"],
                        delta, alpha, valid=carry["prev_valid"])
                else:
                    new["table"] = update_td(carry["table"], carry["prev_after"], delta, alpha,
                                             valid=carry["prev_valid"])

        return update

    def _restart(self):
        """The rest of the step after its update: ``restart(carry, new,
        draws, after, r, v_after, alive) -> (n_done, done_score, highest)``
        does the episode bookkeeping, spawns, restarts finished games
        (fresh or from the carousel) and writes the boards, scores, the
        carousel and the ``prev_*`` leaves into ``new``. The function holds
        the config and the network, not the trainer (as :meth:`_update`)."""
        cfg, net = self.cfg, self._net

        def restart(carry: dict, new: dict, draws: dict, after, r, v_after, alive):
            boards = carry["boards"]
            # episode bookkeeping: a board resets when it has no legal move
            score = carry["score"] + torch.where(alive, r, 0.0)
            done = ~alive
            n_done = done.sum().to(torch.float32)
            done_score = torch.where(done, score, 0.0).sum()
            highest = boards.max()

            with profiler.span("td.restart"):
                next_state = rules.spawn(after, draws["spawn_val"], draws["spawn_pos"])
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
            return n_done, done_score, highest

        return restart

    def _values(self):
        return self._net if self._net is not None else self._small

    @staticmethod
    def _combine(carry: dict, idx: torch.Tensor, alpha) -> None:
        """The delayed-TC combine of the pending sums into ``carry``'s
        table, ``tc_e`` and ``tc_a``, all in place, over the entries at the
        window's recorded occurrence indices ``idx``, whose pending sums it
        leaves at zero (``ntuple.tc_combine_at``), counted in the
        profiler's ``td.sparse_combines``."""
        with profiler.span("td.combine"):
            profiler.count("td.sparse_combines", 1)
            tc_combine_at(carry["table"], carry["tc_e"], carry["tc_a"],
                          tuple(carry[p] for p in _PENDING), idx, alpha)

    @property
    def _defer_tc(self) -> bool:
        """Delayed TC: the TC statistics accumulate between combines."""
        return self.cfg.tc and self.cfg.tc_every > 1

    def _windows(self, length: int) -> int:
        """Steps between delayed-TC combines (``length`` without delayed TC)."""
        if not self._defer_tc:
            return length
        k = self.cfg.tc_every
        if length % k:
            raise ValueError(f"{length} steps do not divide into windows of {k}")
        return k

    def _scan_steps(self, carry: dict, alpha, length: int):
        """``length`` steps, each with its draws from the carry's generator.
        A step draws into the buffer of a :class:`_StepTail`, runs the
        greedy search (:class:`_GreedySearch`) on the tail's boards and
        table, without delayed TC the update with its ``alpha`` eagerly (it
        writes the table in place), then the tail on the search's results:
        on the card the search and the tail are each one CUDA graph replay,
        elsewhere plain calls. With ``cfg.tc_every > 1`` (delayed TC) the
        TC statistics accumulate in the tail's pending sums and each step's
        occurrence indices in its window record, and the combine runs
        eagerly at the end of every window of ``tc_every`` steps (windows
        start at the scan's start), writing the table, ``tc_e`` and
        ``tc_a`` in place: the latter two are copied once, at the start, so
        that the given carry's stay as they were. The tail, and the search
        with it, is built at the first call and again when the shapes, the
        step count or torch's kernel flags change; the carry's leaves and
        table are copied into it at the start and out of it at the end.
        Returns a new carry (the given one's generator, advanced) and the
        per-step stats stacked ``(length,)``."""
        k, defer = self._windows(length), self._defer_tc
        key = _StepTail.key_of(carry, length)
        if self._tail is None or self._tail.key != key:
            self._tail = self._greedy = None  # the old graphs and buffers go first
            window = (k, carry["boards"].shape[0] * self._net.n_features) if defer else None
            self._tail = _StepTail(carry, length, self._update(None, True) if defer else None,
                                   self._restart(), window)
        tail = self._tail
        if self._greedy is None or not self._greedy.fits(tail):
            self._greedy = None
            self._greedy = _GreedySearch(self._values(), tail)
        greedy = self._greedy
        state = dict(carry)
        state.update(tail.load(carry))
        if defer:  # the combine writes them in place
            state.update((k, carry[k].clone()) for k in ("tc_e", "tc_a"))
        gen = carry["generator"]
        update = None if defer else self._update(alpha, False)
        for t in range(length):
            self._draws(gen, tail.u)
            found = greedy.replay()
            if update is not None:
                update(state, state, *found[1:])
            tail.replay(found)
            if defer and (t + 1) % k == 0:
                self._combine(state, tail.window_idx, alpha)
        return tail.unload(state)

    def train_chunk(self, state: dict, alpha):
        """``cfg.chunk_steps`` TD steps over all envs; returns ``(state,
        metrics)`` with the metrics as device tensors (no host sync).

        One greedy search per step: the target of step t-1's afterstate is
        assembled from step t's greedy result, so each board is searched
        once per move. The returned state is new, except its generator,
        which is the given state's and has advanced (JAX donates the
        state)."""
        self.chunks += 1
        with profiler.span("td.chunk", unit=self.chunks):
            profiler.count("td.steps", self.cfg.chunk_steps)
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

    def make_sharded_chunk(self, mesh) -> ShardedChunk:
        """Chunk-synchronous data-parallel TD over the ``data`` axis of
        ``mesh``: a :class:`ShardedChunk`, called as ``fn(state, alpha) ->
        (state, metrics)`` on a :func:`shard_td_state` state."""
        return ShardedChunk(self, mesh)

    def learn(self, state: dict | None = None, log_every: int = 50, log_fn=print,
              ckpt_path=None, ckpt_every: int = 0, start_chunk: int = 0,
              max_chunks: int | None = None, mesh=None):
        """Run training; the step count rounds UP to whole chunks of
        ``n_envs * chunk_steps``. ``ckpt_path`` + ``ckpt_every`` (chunks)
        save the whole train state with :func:`save_train_state`, so a run
        resumes bit-continuously from it (pass the loaded state and
        ``start_chunk``; alpha's schedule follows from the chunk counter).
        ``max_chunks`` bounds the chunks of this call. Returns ``(state,
        history)``.

        ``mesh`` switches to data-parallel training: every rank passes the
        same whole state (or None), which :func:`shard_td_state` splits, and
        the chunks run through :meth:`make_sharded_chunk`. The state
        returned is this rank's. A checkpoint collects the sharded leaves
        from every rank (:func:`gather_td_state`) and rank 0 writes it;
        only rank 0 logs."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        chunk_fn = self.train_chunk
        if mesh is not None:
            state = shard_td_state(state, mesh)
            chunk_fn = self.make_sharded_chunk(mesh)
            if pmesh.data_rank(mesh) != 0:
                log_fn = None
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
            state, metrics = chunk_fn(state, alpha)
            if ckpt_path and ckpt_every and ((c + 1) % ckpt_every == 0 or c + 1 == stop):
                whole = gather_td_state(state, mesh)
                if pmesh.data_rank(mesh) == 0:
                    save_train_state(ckpt_path, whole, cfg, chunks_done=c + 1)
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


# state keys whose leading axis is the env batch (sharded over ``data``); the
# carousel reservoirs shard on their slot axis; everything else (the table,
# the TC accumulators, the generator) replicates. Selected by KEY, not by
# shape: a replicated leaf can happen to have the batch's length.
_BATCH_KEYS = frozenset({"boards", "score", "prev_after", "prev_v", "prev_valid"})
_SLOT_KEYS = frozenset({"car_boards", "car_filled"})
# the leaves a step writes, besides the table and its TC accumulators
_STEP_KEYS = _BATCH_KEYS | _SLOT_KEYS
# the leaves a _StepTail holds: those and the table (which its tail's graph
# does not read: the greedy search's graph reads it)
_TAIL_KEYS = _STEP_KEYS | {"table"}
# the additive leaves that the sharded chunk merges
_MERGED = ("table", "tc_e", "tc_a")


def shard_td_state(state: dict, mesh) -> dict:
    """This rank's part of a TD train state: its block of the env batch
    (``boards``, ``score``, ``prev_*``) and of the carousel reservoirs'
    slots; the table, the TC accumulators and the generator replicated."""
    def place(k, v):
        if k in _BATCH_KEYS:
            return pmesh.shard_batch(v, mesh)
        if k in _SLOT_KEYS:
            return pmesh.shard_batch(v, mesh, axis=1)
        return pmesh.replicate(v, mesh)
    return {k: place(k, v) for k, v in state.items()}


def gather_td_state(state: dict, mesh) -> dict:
    """The inverse of :func:`shard_td_state`: the whole state, collected
    from every rank (a collective; the state itself on a one-rank axis)."""
    def collect(k, v):
        if k in _BATCH_KEYS:
            return pmesh.gather_batch(v, mesh)
        if k in _SLOT_KEYS:
            return pmesh.gather_batch(v, mesh, axis=1)
        return v
    return {k: collect(k, v) for k, v in state.items()}


def _derived_seed(generator: torch.Generator, tag: bytes) -> int:
    """A 63-bit seed from the SHA-256 of ``generator``'s state and ``tag``
    (no device sync: a CUDA generator's state lives on the host)."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes() + tag).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class ShardedChunk:
    """One chunk of chunk-synchronous data-parallel TD (the JAX package's
    ``make_sharded_chunk``): each rank runs the whole chunk's steps locally,
    on its block of the envs against its own copy of the table, and then
    the chunk's changes of the additive leaves merge: ``table``, ``tc_e`` and
    ``tc_a`` each become ``t0 + sum over ranks of (new - t0)``. Episodes and
    the finished games' score sum over the ranks, ``highest_exp`` is the
    max. One merge per chunk: within a chunk the ranks do not see each
    other's updates. The carousel reservoirs are sharded on the slot axis,
    each rank's fed by its own envs (reservoir writes are not additive), so
    ``n_envs`` and ``carousel_slots`` must divide over the ranks.

    Randomness (the counterpart of JAX folding the axis index into the
    chunk key): the state's generator is replicated. At the start of a
    chunk, rank r draws its chunk from a fresh generator on the same device
    seeded with the first 8 bytes (little-endian, shifted right by one) of
    ``sha256(state generator's get_state() bytes + b"rank %d" % r)``;
    after the merge the state's generator is reseeded the same way from
    ``b"next"``, identically on every rank, so chunks chain.

    On a one-rank axis the call is :meth:`TDTrainer.train_chunk` itself:
    no derivation, no merge, the same result bit for bit.

    A call is :meth:`local`, :meth:`reduce` (the merge's one collective)
    and :meth:`merge`. A test may run the ranks in turn in one process:
    :meth:`local` for each, the sums (and the max) of their parts taken
    over them in place of :meth:`reduce`, then :meth:`merge` for each."""

    def __init__(self, trainer: TDTrainer, mesh):
        cfg = trainer.cfg
        self.trainer = trainer
        self.mesh = mesh
        self.world = pmesh.data_size(mesh)
        self.rank = pmesh.data_rank(mesh)
        if cfg.n_envs % self.world:
            raise ValueError(f"n_envs {cfg.n_envs} does not split over {self.world} ranks")
        if cfg.carousel and cfg.carousel_slots % self.world:
            raise ValueError(f"carousel_slots {cfg.carousel_slots} do not split over "
                             f"{self.world} ranks")

    def reduce(self, parts: dict) -> dict:
        """``parts`` (``table``/``tc_e``/``tc_a``: this rank's changes;
        ``episodes``, ``done_score``: sums; ``highest``: a max) reduced in
        place over the mesh's ``data`` axis."""
        return {k: pmesh.all_reduce(v, self.mesh, "max" if k == "highest" else "sum")
                for k, v in parts.items()}

    def local(self, state: dict, alpha) -> tuple[dict, dict]:
        """This rank's chunk from its part of the state -> ``(new local
        state, parts)``, ``parts`` as :meth:`reduce` takes them."""
        alpha = torch.as_tensor(alpha, dtype=torch.float32)
        local = dict(state)
        gen = state["generator"]
        local["generator"] = torch.Generator(device=gen.device).manual_seed(
            _derived_seed(gen, b"rank %d" % self.rank))
        new, (n_done, done_score, highest) = self.trainer._scan_steps(
            local, alpha, self.trainer.cfg.chunk_steps)
        parts = {k: new[k] - state[k] for k in _MERGED if k in state}
        parts.update(episodes=n_done.sum(), done_score=done_score.sum(),
                     highest=highest.max().to(torch.int32))
        return new, parts

    def merge(self, state: dict, new: dict, totals: dict) -> tuple[dict, dict]:
        """The merged state and the chunk's metrics from this rank's chunk
        ``new`` and the reduced ``totals``; advances the state's generator."""
        new = dict(new)
        for k in _MERGED:
            if k in state:
                new[k] = state[k] + totals[k]
        gen = state["generator"]
        gen.manual_seed(_derived_seed(gen, b"next"))
        new["generator"] = gen
        episodes = totals["episodes"]
        metrics = {"episodes": episodes,
                   "ep_score_mean": totals["done_score"] / episodes.clamp(min=1.0),
                   "highest_exp": totals["highest"].to(torch.int32)}
        return new, metrics

    def __call__(self, state: dict, alpha):
        if self.world == 1:
            return self.trainer.train_chunk(state, alpha)
        new, parts = self.local(state, alpha)
        return self.merge(state, new, self.reduce(parts))


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
                   help="chunk-synchronous data-parallel training over the ranks of "
                   "torchrun (one table merge per chunk); rank 0 logs, saves and evaluates")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for the plain path)")
    args = p.parse_args(argv)
    if args.arch == "small" and "rows" in (args.update_impl, args.value_impl):
        p.error('--update-impl/--value-impl "rows" applies to the big-net architectures '
                'only (--arch 4x6/5x6/4x6_4x4); the small net supports auto/scatter/mxu '
                'updates and auto/gather/mxu/mxu_bf16 values')
    mesh, device = None, torch.device(args.device)
    if args.sharded:
        pmesh.init_distributed(backend=pmesh.default_backend(device))
        mesh = pmesh.make_mesh()
        device = pmesh.rank_device(device)
    rank0 = pmesh.data_rank(mesh) == 0

    cfg = TDConfig(
        total_steps=args.steps, n_envs=args.envs, alpha=args.alpha,
        alpha_final=args.alpha_final, init_value=args.init_value,
        seed=args.seed, chunk_steps=args.chunk_steps,
        update_impl=args.update_impl, value_impl=args.value_impl,
        tc=args.tc, arch=args.arch, n_vals=args.n_vals,
        thresholds=tuple(args.thresholds), tc_every=args.tc_every,
        carousel=args.carousel, carousel_slots=args.carousel_slots,
    )
    trainer = TDTrainer(cfg, device=device)
    state = trainer.init_state()
    start_chunk = 0
    if args.resume:
        if is_train_state(args.resume):
            state, meta = load_train_state(args.resume, device=device)
            start_chunk = meta["chunks_done"]
            if rank0:
                print(f"resumed full train state at chunk {start_chunk} "
                      f"({start_chunk * cfg.n_envs * cfg.chunk_steps} steps)")
        else:
            variables, _ = load_model(args.resume)
            state["table"] = interop.table_from_numpy(variables["table"], device)
    state, history = trainer.learn(state, ckpt_path=args.ckpt, ckpt_every=args.ckpt_every,
                                   start_chunk=start_chunk, mesh=mesh)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if not rank0:
        return
    save_model(args.output, {"table": state["table"]},
               meta={"config": dataclasses.asdict(cfg)})

    ev = play_greedy(state["table"], args.eval_episodes,
                     torch.Generator(device=device).manual_seed(args.seed + 1),
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
