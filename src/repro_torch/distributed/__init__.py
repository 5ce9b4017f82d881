from repro_torch.distributed.sharding import (
    MeshEnv,
    P,
    PartitionSpec,
    Sharded,
    all_reduce,
    get_env,
    local_mesh_env,
    set_env,
    shard,
    single_device_env,
    unshard,
)

__all__ = [
    "MeshEnv",
    "P",
    "PartitionSpec",
    "Sharded",
    "all_reduce",
    "get_env",
    "local_mesh_env",
    "set_env",
    "shard",
    "single_device_env",
    "unshard",
]
