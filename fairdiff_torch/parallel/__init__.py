from fairdiff_torch.parallel.mesh import (
    MeshConfig,
    create_mesh,
    init_distributed,
    local_slice,
    replicated,
    shard_batch,
)
from fairdiff_torch.parallel.tp import sd_param_specs, shard_sd_modules

__all__ = [
    "MeshConfig",
    "create_mesh",
    "init_distributed",
    "local_slice",
    "replicated",
    "shard_batch",
    "shard_sd_modules",
    "sd_param_specs",
]
