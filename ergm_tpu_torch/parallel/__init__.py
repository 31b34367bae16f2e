"""Parallelism layer (counterpart of ``ergm_tpu/parallel``): device
meshes over the world's ranks, the Megatron partition rules, ZeRO-1.

The helpers live in ``ergm_tpu_torch.core.mesh`` (the training path
needs them without import cycles); this package is the public surface,
and ``parallel.distributed`` joins the processes.
"""

from ergm_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, batch_rows,  # noqa: F401
                                      logical_to_sharding, make_mesh, param_partition_spec,
                                      shard_params)
