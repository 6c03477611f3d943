"""Models (counterpart of ``gym2048_tpu.models``): the n-tuple networks and
their table lookup kernel (``ntuple``, ``ntuple_big``, ``table_gather``),
and the residual CNNs of ``resnet``."""

from gym2048_tpu_torch.models.resnet import (
    ActorCritic,
    Game2048Model,
    ResidualBlock,
    boards_to_model_input,
    build_model,
)

__all__ = ["ActorCritic", "Game2048Model", "ResidualBlock", "boards_to_model_input",
           "build_model"]
