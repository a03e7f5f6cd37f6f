"""Scale-out (counterpart of ``mbrl_tpu/parallel/``): the real-environment
worker pool, the (model, data) mesh on ``torch.distributed`` and multi-process
start-up. One process per device."""
from .context import ParallelContext, make_parallel_context
from .env_workers import EnvWorkerPool
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ensemble_param_sharding,
    make_mesh,
    replicate,
    shard_ensemble_params,
    shard_member_batch,
    shard_particles,
)
from .multihost import (
    global_mesh,
    local_worker_slice,
    maybe_initialize_distributed,
    process_info,
    run_multihost_dryrun,
)

__all__ = [
    "MODEL_AXIS",
    "DATA_AXIS",
    "make_mesh",
    "ensemble_param_sharding",
    "shard_ensemble_params",
    "shard_member_batch",
    "shard_particles",
    "replicate",
    "EnvWorkerPool",
    "ParallelContext",
    "make_parallel_context",
    "maybe_initialize_distributed",
    "process_info",
    "global_mesh",
    "local_worker_slice",
    "run_multihost_dryrun",
]
