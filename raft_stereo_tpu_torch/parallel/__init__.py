"""Training across processes and cards: the port's counterpart of
`raft_stereo_tpu/parallel` (the rank layout, the (data, spatial) mesh, the
sharding rule engine and its presets, pod-wide agreement on the
resilience signals)."""

from raft_stereo_tpu_torch.parallel.coordination import HostCoordinator, PodDecision
from raft_stereo_tpu_torch.parallel.distributed import host_shard_args, init_multihost, process_topology
from raft_stereo_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    P,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from raft_stereo_tpu_torch.parallel.sharding import (
    PRESETS,
    ShardingEngine,
    explain_sharding,
    make_shard_and_gather_fns,
    match_partition_rules,
    resolve_mesh_shape,
)

__all__ = [
    "DATA_AXIS",
    "HostCoordinator",
    "P",
    "PRESETS",
    "PodDecision",
    "SPATIAL_AXIS",
    "ShardingEngine",
    "batch_sharding",
    "explain_sharding",
    "host_shard_args",
    "init_multihost",
    "make_mesh",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "process_topology",
    "replicated",
    "resolve_mesh_shape",
    "shard_batch",
]
