"""Multi-process initialization: the port's counterpart of
`raft_stereo_tpu/parallel/distributed.py`.

The JAX package runs one process per host, each driving all of its chips,
and connects the hosts with `jax.distributed.initialize()`. PyTorch runs one
process per card (a rank). `torchrun` (`python -m torch.distributed.run`)
starts the ranks and sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR and MASTER_PORT; `init_multihost()` reads them, or takes them
as arguments, binds the card LOCAL_RANK names before `init_process_group`,
and picks the backend: NCCL on a card, gloo on the CPU. An explicit
`backend` overrides that choice; gloo carries CUDA tensors too, which is
how two ranks share one card (NCCL refuses two ranks on one device). That
choice plays the role of the JAX module's `_enable_cpu_collectives`.

Without WORLD_SIZE (and no arguments) there is one process and
`init_multihost()` is a no-op, so entry points call it unconditionally.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_multihost(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    init_method: Optional[str] = None,
    device: Optional[str] = None,
) -> dict:
    """Join the process group when running multi-process; a no-op when
    already joined or when there is one process. `device` is "cuda" or
    "cpu" (default: the card when there is one); on "cuda" the rank binds
    card `local_rank` first. `init_method` defaults to "env://"
    (MASTER_ADDR and MASTER_PORT). Returns {process_index, process_count,
    local_rank, local_world_size, backend}."""
    import torch.distributed as dist

    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world is not None and not dist.is_initialized():
        rank = rank if rank is not None else (_env_int("RANK") or 0)
        local = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
        local = rank if local is None else local
        kind = device or ("cuda" if torch.cuda.is_available() else "cpu")
        if kind == "cuda":
            torch.cuda.set_device(local)
        backend = backend or ("nccl" if kind == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world)
        logger.info("process group joined: rank %d of %d (local rank %d), backend %s", rank, world, local, backend)
    return topology()


def topology() -> dict:
    """This process's place: {process_index, process_count, local_rank,
    local_world_size, backend}; (0, 1, 0, 1, None) outside a process
    group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_rank": 0, "local_world_size": 1, "backend": None}
    rank = dist.get_rank()
    local = _env_int("LOCAL_RANK")
    return {
        "process_index": rank,
        "process_count": dist.get_world_size(),
        "local_rank": rank if local is None else local,
        "local_world_size": _env_int("LOCAL_WORLD_SIZE") or 1,
        "backend": dist.get_backend(),
    }


def process_topology() -> tuple:
    """(process_index, process_count): the one place the rank layout is
    read, so tests can mock multi-rank layouts (loader sharding, pod
    coordination, budget math) in one process by patching here."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_shard_args(mesh_shape=(-1, 1)) -> dict:
    """(host_id, num_hosts) kwargs for the DataLoader's input sharding over
    the data axis of a (data, spatial) `mesh_shape`: each data group reads
    its own stride of the epoch order, and the ranks of one spatial group
    read the same samples with the same augmentation (the loader's streams
    are keyed on (seed, epoch, index)), each then keeping its row band."""
    from raft_stereo_tpu_torch.parallel.mesh import mesh_coordinates

    index, count = process_topology()
    data_index, data, _, _ = mesh_coordinates(index, count, tuple(mesh_shape))
    return {"host_id": data_index, "num_hosts": data}


def shutdown() -> None:
    """Leave the process group, if joined (every exit path of `train`)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
