"""Multi-device: data parallel, tensor parallel and ZeRO-1 (the JAX package's ``parallel``)."""

from dualvgr_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    data_mesh,
    maybe_initialize_distributed,
    prefetch_to_device,
    process_batch_bounds,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_batch_local,
)
from dualvgr_tpu_torch.parallel.tp import (  # noqa: F401
    dp_tp_mesh,
    mesh_for,
    place_state,
    shard_opt_state_zero,
    shard_state_tp,
    tp_sharded_leaf_count,
)
