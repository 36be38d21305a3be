"""Process-group start-up and the mesh over every rank (counterpart of
``drtk_tpu/parallel/multihost.py``).

* :func:`initialize` brings up ``torch.distributed`` once per process.
  Given nothing, it reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``
  and ``RANK`` (``env://``, as ``torchrun`` sets them); otherwise pass an
  ``init_method`` (``tcp://host:port`` or ``file:///path``), the world size
  and this process's rank. Nothing on a machine tells a program of a
  cluster.
* :func:`make_pod_mesh` is a (data, pix) mesh over all ranks, factored as
  :func:`~drtk_tpu_torch.parallel.sharding.mesh_shape` factors it; the pix
  axis is innermost, so a pix group is consecutive ranks (one host's cards
  where a host holds whole groups).

A program, the same on every rank::

    from drtk_tpu_torch.parallel import multihost, spmd

    multihost.initialize()
    mesh = multihost.make_pod_mesh(batch=n_cameras)
    forward = spmd.make_row_sharded_forward(mesh, vi, H, W)
    block = forward(v, vt, tex)  # this rank's cameras and rows
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from drtk_tpu_torch.parallel.sharding import make_mesh

__all__ = ["initialize", "make_pod_mesh"]


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               backend: str = "nccl") -> None:
    """Start the default process group, once: a no-op when one is already
    up. Under NCCL (the default: one card per rank) the process takes card
    ``LOCAL_RANK`` if set, else its rank modulo the cards it sees; use
    ``backend="gloo"`` for CPU ranks."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend,
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
    )
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else dist.get_rank() % torch.cuda.device_count())


def make_pod_mesh(batch: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """(data, pix) mesh over every rank of the default group."""
    return make_mesh(None, batch, device_type)
