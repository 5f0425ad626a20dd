"""Multi-device serving (counterpart of ``samd_tpu/parallel``): the mesh
and sharding rules, sequence parallelism, process-group set-up, and the
collectives that stand in for GSPMD's (``comm``)."""

from .sharding import (
    Mesh,
    check_shardable,
    kv_spec,
    make_mesh,
    param_specs,
    shard_kv,
    shard_params,
)

__all__ = [
    "Mesh", "make_mesh", "check_shardable", "param_specs", "kv_spec",
    "shard_params", "shard_kv",
]
