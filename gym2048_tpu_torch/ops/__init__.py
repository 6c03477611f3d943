"""Tensor transforms of boards, actions and rewards (counterpart of
``gym2048_tpu.ops``): observation encoders, the 8x symmetry augmentation
and the reward math. Plain PyTorch on the tensors' own device."""

from gym2048_tpu_torch.ops import augment, obs, returns  # noqa: F401
