"""Sharding rules and the parallel context of serving on a device mesh."""
from repro_torch.distributed.sharding import (  # noqa: F401
    AbstractMesh,
    MeshAxes,
    ParallelContext,
    batch_spec,
    cache_shardings,
    paged_cache_shardings,
    param_shardings,
    shard_params,
)
