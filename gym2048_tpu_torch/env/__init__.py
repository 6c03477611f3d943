"""Environments (counterpart of ``gym2048_tpu.env``): the batched env on the
device (``batched``), the numpy single env of the reference
(``adapter``) and its spawn streams (``parity``). ``registration`` (the
gymnasium class, ``Torch2048-v0``) and ``vector`` (a gymnasium
``VectorEnv``) import gymnasium and are not imported here."""

from gym2048_tpu_torch.env.batched import EnvConfig, EnvState, TimeStep

__all__ = ["EnvConfig", "EnvState", "TimeStep"]
