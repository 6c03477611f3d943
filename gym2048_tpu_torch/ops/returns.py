"""Reward math: log2 rewards, discounted returns, GAE (counterpart of
``gym2048_tpu/ops/returns.py``).

The JAX module's reverse ``lax.scan`` is a reverse loop over the leading
time axis here, on the tensors' own device: T steps of a few elementwise
operations each, with no copy to the host.
"""

from __future__ import annotations

import torch


def log2_rewards(rewards: torch.Tensor) -> torch.Tensor:
    """log2 of positive rewards, 0 elsewhere (the reference's masked log)."""
    r = rewards.to(torch.float32)
    return torch.where(r > 0, torch.log2(r.clamp(min=1e-30)), 0.0)


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       gamma: float = 0.9) -> torch.Tensor:
    """Discounted return ``(T,)`` f32 with resets at episode ends, from the
    last step back: ``G[t] = r[t] + (0 if done[t] else gamma * G[t + 1])``
    (the reference: ``done[t]`` cuts the bootstrap of step t itself)."""
    r = rewards.to(torch.float32)
    out = torch.empty_like(r)
    g = torch.zeros((), dtype=torch.float32, device=r.device)
    for t in range(r.shape[0] - 1, -1, -1):
        g = r[t] + torch.where(dones[t], 0.0, gamma * g)
        out[t] = g
    return out


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float = 0.99,
        lam: float = 0.95) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalised advantage estimation over a time-major rollout.

    ``rewards``, ``values`` and ``dones`` are ``(T, ...)``; ``dones[t]``
    marks that step t ended its episode (no bootstrap across it);
    ``last_value`` ``(...)`` is V(s_T), which bootstraps the last step.
    Returns ``(advantages, returns)``, both ``(T, ...)`` f32, with
    ``returns = advantages + values``."""
    rewards = rewards.to(torch.float32)
    values = values.to(torch.float32)
    not_done = 1.0 - dones.to(torch.float32)
    next_value = last_value.to(torch.float32)
    next_adv = torch.zeros_like(next_value)
    advantages = torch.empty_like(rewards)
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * not_done[t] - values[t]
        next_adv = delta + gamma * lam * not_done[t] * next_adv
        advantages[t] = next_adv
        next_value = values[t]
    return advantages, advantages + values


def normalize(x: torch.Tensor, mean=None, sd=None) -> torch.Tensor:
    """``(x - mean) / sd`` in f32, the moments over the whole tensor unless
    given (``sd`` the population standard deviation, as ``jnp.std``)."""
    x = x.to(torch.float32)
    if mean is None:
        mean = x.mean()
    if sd is None:
        sd = x.std(correction=0)
    return (x - mean) / sd
