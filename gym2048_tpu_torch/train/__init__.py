"""Learners (counterpart of ``gym2048_tpu.train``; only the TD trainer of the
big n-tuple networks is ported yet)."""
