from .ctx import REPLICA_AXIS, replica_mesh
from .partition import (
    PartitionSpec,
    batch_partition,
    cache_partition,
    named,
    param_partition,
)

__all__ = [
    "PartitionSpec",
    "REPLICA_AXIS",
    "batch_partition",
    "cache_partition",
    "named",
    "param_partition",
    "replica_mesh",
]
