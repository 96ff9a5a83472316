"""Multi-device execution: one process per device over
``torch.distributed`` (the port's counterpart of
``timbre_trap_tpu/parallel``, which drives N devices from one process)."""

from .mesh import (make_mesh, replicated, batch_sharded, shard_batch,
                   shard_global_batch, plan_local_rows, LocalBatchPlan,
                   DATA_AXIS)
from .inference import make_sharded_chunked_inference
from .distributed import initialize, is_multi_host, local_batch_slice

__all__ = ["make_mesh", "replicated", "batch_sharded", "shard_batch",
           "shard_global_batch", "plan_local_rows", "LocalBatchPlan",
           "DATA_AXIS", "make_sharded_chunked_inference",
           "initialize", "is_multi_host", "local_batch_slice"]
