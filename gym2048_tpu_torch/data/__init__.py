"""Training data on the host (counterpart of ``gym2048_tpu.data``)."""

from gym2048_tpu_torch.data.training_data import TrainingData, training_data

__all__ = ["TrainingData", "training_data"]
