"""Search agents (counterpart of ``gym2048_tpu.agents``)."""
