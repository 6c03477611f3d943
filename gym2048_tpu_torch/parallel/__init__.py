"""Data parallelism over ``torch.distributed`` (counterpart of
``gym2048_tpu.parallel``): see :mod:`gym2048_tpu_torch.parallel.mesh`."""

from gym2048_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    shard_env_state,
    shard_train_state,
)
