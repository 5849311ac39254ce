"""The (data, spatial) mesh and the batch layout: the port's counterpart of
`raft_stereo_tpu/parallel/mesh.py`.

The JAX package lays every chip of the pod on a `jax.sharding.Mesh` with
axes ("data", "spatial") and lets XLA insert the collectives. Here the mesh
is the ranks of the process group: `make_mesh` resolves the shape as JAX
does (a -1 is inferred from the world size) and, inside a process group,
builds `torch.distributed.device_mesh.init_device_mesh` with the same axis
names, which DistributedDataParallel and FSDP2 run their collectives over.

Two differences from JAX, both forced by PyTorch's execution model:
- a JAX mesh may leave devices out (a 2x1 mesh on an 8-chip host); a torch
  rank cannot sit out of a collective step, so a mesh that does not cover
  the world is refused with the shape it would need;
- the batch is placed by each rank reading its data group's rows (the
  loader's stride over the data axis, data/loader.py), so `shard_batch`
  only moves them to the rank's device and, on a spatial axis above 1,
  keeps this rank's band of image rows: the ranks of one spatial group
  read the same samples and each keeps its band.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class P(tuple):
    """A partition spec: one entry per leading tensor dim, a mesh axis name
    or None (replicated along that dim), as `jax.sharding.PartitionSpec`.
    `P()` is fully replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, spatial) mesh over the ranks. `device_mesh` is the torch
    DeviceMesh inside a process group, None in a single process (or when
    the mesh is only described, as the tests and `--explain_sharding` do)."""

    data: int
    spatial: int = 1
    device_mesh: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SPATIAL_AXIS: self.spatial}

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (0 without a DeviceMesh)."""
        return self.device_mesh.get_local_rank(axis) if self.device_mesh is not None else 0


def mesh_coordinates(rank: int, world: int, mesh_shape: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """(data index, data size, spatial index, spatial size) of `rank` in a
    (data, spatial) mesh over `world` ranks laid out as `make_mesh` lays
    them (row-major: rank = data index * spatial + spatial index), with
    -1 resolved as there. No process group needed (the loader's shard)."""
    d, s = make_mesh(mesh_shape, world_size=world).shape.values()
    return rank // s, d, rank % s, s


def make_mesh(mesh_shape: Tuple[int, int] = (-1, 1), world_size: Optional[int] = None,
              device_type: Optional[str] = None) -> Mesh:
    """A (data, spatial) mesh over `world_size` ranks (default: the process
    group's size, 1 outside one). `-1` infers the axis size as JAX does.
    Inside a process group with `device_type` given, the DeviceMesh is
    built (a collective: every rank calls this at the same point)."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if joined else 1)
    d, s = mesh_shape
    if d == -1:
        if n % max(s, 1):
            raise ValueError(f"{n} ranks not divisible by spatial={s}")
        d = n // s
    if s == -1:
        s = n // d
    if d * s != n:
        want = f"{n // s} {s}" if s > 0 and n % s == 0 else f"{n} 1"
        raise ValueError(
            f"mesh {d}x{s} covers {d * s} rank(s) but the world has {n}: a rank cannot sit out of a "
            f"collective step; use --mesh_shape {want} (or -1 {s})")
    device_mesh = None
    if joined and device_type is not None:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device_type, (d, s), mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))
    return Mesh(d, s, device_mesh)


def batch_sharding(mesh: Mesh) -> P:
    """The NHWC batch layout: batch over data, image rows over spatial."""
    return P(DATA_AXIS, SPATIAL_AXIS, None, None)


def replicated(mesh: Mesh) -> P:
    return P()


def shard_batch(mesh: Mesh, batch: Mapping[str, Any], device="cpu",
                spatial_index: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's part of the global batch on its device, as float32
    tensors. Each rank's loader already produced its data group's rows (the
    global batch is the data groups' rows in order); on a spatial axis
    above 1 this rank keeps the image rows [k*H/s, (k+1)*H/s) of them, k
    its spatial coordinate (`spatial_index`, default the DeviceMesh's).
    Nothing is communicated; non-array entries (paths) are dropped. A host
    batch reaches a card from pinned memory without blocking the host (the
    step makes no sync); a batch already on the device stays there."""
    k = mesh.coordinate(SPATIAL_AXIS) if spatial_index is None else spatial_index
    device = torch.device(device)
    out = {}
    for key in ("image1", "image2", "flow", "valid"):
        t = torch.as_tensor(batch[key])
        if mesh.spatial > 1:
            rows = t.shape[1] // mesh.spatial
            t = t[:, k * rows:(k + 1) * rows]
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.to(torch.float32).contiguous().pin_memory().to(device, non_blocking=True)
        out[key] = t.to(device=device, dtype=torch.float32)
    return out
