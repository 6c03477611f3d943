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
* ``gather``         — interactive human-play collector (gather_training_data.py;
  pygame and matplotlib, imported when it runs)
* ``convert_model``  — weights between the flax-layout .pkl/.npz and the
  reference's torch .pth/.pt and SB3 .zip (no ``--device``: nothing there
  runs on the card)

Run as ``python -m gym2048_tpu_torch.tools.<name> ...``; ``ppo --mesh``
under ``torchrun`` for data parallel.
"""
