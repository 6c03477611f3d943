"""PyTorch/CUDA port of the ``gym2048_tpu`` self-play engine.

The JAX package ``gym2048_tpu`` is the reference; each module here names its
counterpart there. This package imports ``torch`` and numpy and nothing of
JAX or of ``gym2048_tpu``. Importing it builds and loads nothing: the CUDA
library of :mod:`gym2048_tpu_torch.core.fused_step` is compiled at its first
launch (:mod:`gym2048_tpu_torch._build`).

Layout (mirrors ``gym2048_tpu``):

* ``core/rules.py`` — batched 2048 rules on ``(B, 4, 4)`` int8 boards;
* ``env/batched.py`` — the auto-resetting batched environment;
* ``core/fused_step.py`` — the fused move / step / rollout kernels (the
  counterpart of ``core/pallas_step.py``) and their plain versions;
* ``csrc/fused_step.cu`` — the CUDA source of those kernels;
* ``models/`` — the n-tuple networks (the small 17 x 4-cell net and the big
  layouts) and their table lookup kernel (``csrc/table_gather.cu``);
* ``agents/expectimax.py``, ``train/td.py`` — the agents and the TD learner;
* ``ops/`` — observation encoders, symmetry augmentation, reward math;
* ``interop.py`` — state carried over from the JAX package as numpy.
"""

__version__ = "0.1.0"
