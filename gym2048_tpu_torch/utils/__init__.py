"""Utilities (counterpart of ``gym2048_tpu.utils``): checkpoints, model
files and table artifacts (``checkpoint``), the metrics logger
(``metrics``), board rendering (``render``) and episode GIFs (``video``).
``profiler`` and ``debug`` are not ported yet (ROADMAP.md, Queue 1)."""
