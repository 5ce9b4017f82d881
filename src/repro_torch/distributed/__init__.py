from repro_torch.distributed.sharding import (
    MeshEnv,
    all_reduce,
    get_env,
    local_mesh_env,
    set_env,
    single_device_env,
)

__all__ = [
    "MeshEnv",
    "all_reduce",
    "get_env",
    "local_mesh_env",
    "set_env",
    "single_device_env",
]
