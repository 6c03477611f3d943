"""Rules and fused step kernels (counterpart of ``gym2048_tpu.core``)."""
