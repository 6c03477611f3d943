"""Batched environment (counterpart of ``gym2048_tpu.env.batched``)."""

from gym2048_tpu_torch.env.batched import EnvConfig, EnvState, TimeStep

__all__ = ["EnvConfig", "EnvState", "TimeStep"]
