"""The benchmark of gym2048_tpu_torch: see README.md."""
