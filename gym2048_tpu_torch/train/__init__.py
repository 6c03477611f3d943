"""Learners (counterpart of ``gym2048_tpu.train``): the TD trainer of the
n-tuple networks (``td``), PPO (``ppo``), behavioural cloning (``bc``) and
the evaluators (``eval``: the reference protocol's host loop and the
batched one on the device)."""

from gym2048_tpu_torch.train.bc import BCConfig, BCTrainer, build_bc_trainer_for_ppo
from gym2048_tpu_torch.train.ppo import PPO, PPOConfig

__all__ = ["BCConfig", "BCTrainer", "PPO", "PPOConfig", "build_bc_trainer_for_ppo"]
