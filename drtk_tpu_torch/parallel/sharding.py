"""The (data, pix) device mesh and the pipeline's tensor layouts on it
(counterpart of ``drtk_tpu/parallel/sharding.py``).

* **data** — cameras (the batch dimension N);
* **pix** — image rows H. Rasterize, render, interpolate and shading are
  per pixel, so a row block is a bit-exact viewport of the frame; the
  edge_grad stencil reads one halo row from the next block.

Vertices and topology are replicated over pix; their gradients are summed
over it (:func:`~drtk_tpu_torch.ops.math.psum_cotangent`).

:func:`make_mesh` factors the ranks as the JAX package factors its
devices (:func:`mesh_shape`) into a ``torch.distributed.device_mesh.
DeviceMesh`` with dims ``("data", "pix")``; :func:`pipeline_sharding`
gives the DTensor placements of the pipeline's tensors on it, and
:func:`constrain` lays a tensor out by them. The explicit per-rank
pipeline is :func:`drtk_tpu_torch.parallel.spmd.make_row_sharded_forward`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

__all__ = ["constrain", "make_mesh", "mesh_shape", "pipeline_sharding", "replicated"]


def mesh_shape(n_devices: int, batch: int = 1) -> tuple[int, int]:
    """(data, pix) for ``n_devices``: the data axis takes the largest
    divisor of ``batch`` that divides ``n_devices``; pix takes the rest
    (``drtk_tpu/parallel/sharding.py:39-61``)."""
    if n_devices < 1 or batch < 1:
        raise ValueError(f"mesh_shape: need n_devices >= 1 and batch >= 1, got {n_devices}, {batch}")
    data = 1
    for d in range(min(batch, n_devices), 0, -1):
        if n_devices % d == 0 and batch % d == 0:
            data = d
            break
    return data, n_devices // data


def make_mesh(n_devices: int | None = None, batch: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (data, pix) mesh over ranks ``0 .. n_devices - 1`` of the default
    process group (all of them by default), shaped by :func:`mesh_shape`.

    Every rank of the default group calls it (creating the mesh's groups is
    collective); a rank outside the mesh gets a mesh with no coordinate.
    ``device_type`` is the DTensor device type, "cuda" by default; pass
    "cpu" for a mesh of CPU ranks."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if n > dist.get_world_size():
        raise ValueError(f"make_mesh: {n} devices asked, the process group has {dist.get_world_size()} ranks")
    data, pix = mesh_shape(n, batch)
    return DeviceMesh(device_type, torch.arange(n).reshape(data, pix), mesh_dim_names=("data", "pix"))


def _placements(mesh: DeviceMesh, data_dim: int | None, pix_dim: int | None) -> tuple:
    by_name = {"data": data_dim, "pix": pix_dim}
    return tuple(
        Replicate() if by_name.get(name) is None else Shard(by_name[name]) for name in mesh.mesh_dim_names
    )


def pipeline_sharding(mesh: DeviceMesh) -> dict:
    """DTensor placements (one per mesh dim) of the pipeline's tensors
    (``drtk_tpu/parallel/sharding.py:64-77``):

        image: [N, C, H, W] -> N over data, H over pix
        index: [N, H, W]    -> N over data, H over pix
        verts: [N, V, 3]    -> N over data, replicated over pix
        replicated:         -> replicated over both
    """
    return {
        "image": _placements(mesh, 0, 2),
        "index": _placements(mesh, 0, 1),
        "verts": _placements(mesh, 0, None),
        "replicated": _placements(mesh, None, None),
    }


def constrain(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """``x`` laid out on ``mesh`` by ``placements``: a DTensor is
    redistributed; a plain tensor, the same whole tensor on every rank, is
    distributed (each rank keeps its shard)."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements that replicate a tensor over every dim of ``mesh``."""
    return _placements(mesh, None, None)
