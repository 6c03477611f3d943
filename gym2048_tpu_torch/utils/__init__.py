"""Utilities (counterpart of ``gym2048_tpu.utils``): checkpoints, model
files and table artifacts (``checkpoint``), the metrics logger
(``metrics``), board rendering (``render``), episode GIFs (``video``),
``torch.profiler`` traces and the program's spans and counters
(``profiler``), and board checks, NaN guards and rollout fingerprints
(``debug``)."""
