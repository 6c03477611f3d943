"""Faults planted in the program under test, to show that the check sees
them: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), and an answer altered where it is
produced. Each fault patches one function of the program for as long as
its context lasts; ``calibrate.py --fault <name>`` reads a fault at a
cell's own size, and the tests read each at a tiny size.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def td_unchanged():
    """A TD chunk that returns the state it was given."""
    from gym2048_tpu_torch.train import td

    def make(orig):
        def unchanged(self, state, alpha):
            return state, orig(self, state, alpha)[1]
        return unchanged
    return _patched(td.TDTrainer, "train_chunk", make)


def td_half_batch():
    """The TC statistics of the first half of the envs alone."""
    from gym2048_tpu_torch.models import ntuple_big

    def make(orig):
        def half(self, pending, boards, deltas, valid=None):
            keep = torch.arange(boards.shape[0], device=boards.device) < boards.shape[0] // 2
            return orig(self, pending, boards, deltas, keep if valid is None else valid & keep)
        return half
    return _patched(ntuple_big.NTupleNetwork, "tc_accumulate", make)


def ppo_unchanged():
    """An optimiser step that leaves the parameters as they are:
    ``Optimizer.apply``, the device part of a step that the eager step and
    the captured CUDA graph both run, only zeroes the gradients, in place
    (a graph keeps them as static buffers)."""
    from gym2048_tpu_torch.train import ppo

    def make(orig):
        @torch.no_grad()
        def no_step(self):
            for p in self.params:
                if p.grad is not None:
                    p.grad.zero_()
        return no_step
    return _patched(ppo.Optimizer, "apply", make)


def ppo_half_batch():
    """Every minibatch cut to its first half."""
    from gym2048_tpu_torch.train import ppo

    def make(orig):
        def half(self, data, perm):
            return [mb.map(lambda x: x[: x.shape[0] // 2]) for mb in orig(self, data, perm)]
        return half
    return _patched(ppo.PPO, "_minibatches", make)


def ppo_action_altered():
    """The first env's first sampled action of every rollout turned by one."""
    from gym2048_tpu_torch.train import ppo

    def make(orig):
        def altered(self, state):
            traj, last_value = orig(self, state)
            traj.action[0, 0] = (traj.action[0, 0] + 1) % 4
            return traj, last_value
        return altered
    return _patched(ppo.PPO, "_collect_rollout", make)


def agent_action_altered():
    """Every move the agent picks turned by one."""
    from gym2048_tpu_torch.agents import expectimax

    def make(orig):
        def adaptive(*args, **kwargs):
            policy = orig(*args, **kwargs)
            return lambda params, boards, live: (policy(params, boards, live) + 1) % 4
        return adaptive
    return _patched(expectimax, "make_adaptive_policy", make)


def agent_result_altered():
    """The first game's score, as ``play_policy`` returns it, off by 4."""
    from gym2048_tpu_torch.agents import expectimax

    def make(orig):
        def play(*args, **kwargs):
            result = orig(*args, **kwargs)
            result["Episodes"][0]["total_reward"] += 4.0
            return result
        return play
    return _patched(expectimax, "play_policy", make)


# the faults each entry's cells can have
BY_ENTRY = {
    "td_chunk": (td_unchanged, td_half_batch),
    "ppo_iteration": (ppo_unchanged, ppo_half_batch, ppo_action_altered),
    "play_policy": (agent_action_altered, agent_result_altered),
}
