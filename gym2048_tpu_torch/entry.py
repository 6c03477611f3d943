"""The flagship model's forward as one callable (counterpart of
``__graft_entry__.py::entry``).

:func:`entry` builds the PPO actor-critic at the width the repository
trains and ships, ``ActorCritic(filters=64, residual_blocks=4)`` (the meta
of ``docs/curves/ppo_{long,masked,tpu}_model.pkl``), in eval mode, and 256
empty int8 boards, on the card unless ``device`` says otherwise. Run it as

    fn, args = entry()
    logits, value = fn(*args)

The JAX module's multi-chip dry run runs one process over several
devices; data parallelism here runs one process per rank
(:mod:`gym2048_tpu_torch.parallel`, ``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import torch

from gym2048_tpu_torch.models.resnet import ActorCritic, boards_to_model_input


def entry(device: str | torch.device = "cuda"):
    """``(fn, (model, boards))``: ``fn(model, boards)`` maps ``(B, 4, 4)``
    int8 exponent boards to ``(policy logits (B, 4), value (B,))`` in one
    eval-mode forward without gradients. The weights are flax's
    initialisation from a generator seeded 0."""
    model = ActorCritic(filters=64, residual_blocks=4, device=device)
    boards = torch.zeros((256, 4, 4), dtype=torch.int8, device=device)

    def fn(model, boards):
        with torch.no_grad():
            return model(boards_to_model_input(boards))

    return fn, (model, boards)
