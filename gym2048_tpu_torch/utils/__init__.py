"""Utilities (counterpart of ``gym2048_tpu.utils``; only the loaders of
``utils/checkpoint.py`` are ported yet)."""
