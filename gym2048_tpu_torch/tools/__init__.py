"""CLI tools (counterpart of ``gym2048_tpu.tools``), argparse mains with the
JAX package's flags plus ``--device`` (default ``cuda``; there is no
fallback to the CPU when CUDA is missing):

* ``selfplay``       — transitions from the batched env on the device, to CSV
* ``train``          — supervised pipeline (reference train.py:232-293)
* ``pretrain_bc``    — BC warm-start for PPO (reference pretrain_bc.py)
* ``ppo``            — PPO training with checkpoints and resume (reference ppo_train.py)
* ``evaluate``       — the reference evaluation protocol, or ``--fast`` on the device
* ``merge_data``     — merge CSVs w/ min-high-tile filter (merge_training_data.py)
* ``augment_data``   — 8x augmentation (augment_training_data.py)
* ``hflip_data``     — 2x horizontal flip (hflip_training_data.py)
* ``distribute_data``— orientation-balancing split (distribute_training_data.py)
* ``add_rewards``    — recompute rewards by replay (add_rewards_to_training_data.py)

Run as ``python -m gym2048_tpu_torch.tools.<name> ...``. Not ported yet:
``gather`` (the interactive human-play collector: pygame and matplotlib)
and ``convert_model`` (ROADMAP.md, Queue 1).
"""
