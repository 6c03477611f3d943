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
  layouts) and their table lookup kernel (``csrc/table_gather.cu``), and the
  residual CNNs (``resnet.py``: the BC policy and the PPO actor-critic);
* ``agents/expectimax.py`` — the expectimax agents, with an n-tuple network,
  the heuristic or a PPO critic as the leaf;
* ``train/`` — the TD learner (``td.py``), PPO (``ppo.py``), behavioural
  cloning (``bc.py``) and the evaluators (``eval.py``: the reference
  protocol's host loop and the batched one);
* ``ops/`` — observation encoders, symmetry augmentation, reward math;
* ``core/rules_np.py``, ``env/adapter.py``, ``env/parity.py`` — the numpy
  rules, the reference's single env and its spawn streams (host side);
  ``env/registration.py`` and ``env/vector.py`` — the gymnasium class
  (``Torch2048-v0``) and vector env, which import gymnasium;
* ``native/`` — the g++ engine and CSV codec (``engine2048.cpp``, built
  into ``build/`` at first use), and ``data/`` — ``TrainingData`` and its
  35/36-column CSV schema;
* ``utils/`` — checkpoints, model files and bf16 table artifacts, metrics,
  rendering and GIFs, ``torch.profiler`` traces and the program's spans
  (``profiler``), board checks and rollout fingerprints (``debug``);
* ``parallel/`` — the ``(data, model)`` mesh over ``torch.distributed`` and
  the data-parallel layout of the TD learner's sharded chunk and of PPO;
* ``tools/`` — the CLIs (selfplay, train, pretrain_bc, ppo, evaluate, the
  CSV tools, the human-play collector ``gather`` and ``convert_model``),
  ``python -m gym2048_tpu_torch.tools.<name>``;
* ``interop.py`` — state and CNN weights carried between the JAX package and
  the port as numpy;
* ``entry.py`` — the flagship actor-critic's forward as one callable, and
  the multi-rank dry run (``dryrun_multichip``);
* ``bench.py`` and ``scaling_bench.py`` — the headline benchmark (root
  ``bench.py``'s line) and the weak-scaling harness over meshes of ranks.
"""

__version__ = "0.1.0"
