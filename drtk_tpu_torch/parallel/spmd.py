"""The rendering pipeline, one row block per rank (counterpart of
``drtk_tpu/parallel/spmd.py``).

Every rank of a (data, pix) mesh runs the pipeline on its own cameras (its
data row's share of the batch) and its own block of rows, with exactly
these collectives, all in the backward:

* rasterize, render and interpolate evaluate only the block's rows, as a
  bit-exact row-tile viewport of the full frame: no communication in the
  forward;
* edge_grad's backward fetches one halo row of img, the cotangent, the
  index and bary from the next rank of the pix group
  (:func:`~drtk_tpu_torch.ops.math.next_rank_rows`);
* the vertex, uv and texture gradients, reduced locally on each rank,
  are summed over the pix group by one all-reduce per input
  (:func:`~drtk_tpu_torch.ops.math.psum_cotangent`), where shard_map's
  transpose inserts the JAX package's psums.

On the card each rank launches the kernels of the single-device step:
B1 under the viewport, B2 five times, B3 three times, B4 in the texture
gradient. Under NCCL (one card per rank) the halo rows move between the
cards; under Gloo they travel through host memory (the backend rule of
:mod:`drtk_tpu_torch.ops.math`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from drtk_tpu_torch import tracing
from drtk_tpu_torch.ops.edge_grad import edge_grad_estimator
from drtk_tpu_torch.ops.grid_sample import grid_sample
from drtk_tpu_torch.ops.interpolate import interpolate
from drtk_tpu_torch.ops.math import psum_cotangent
from drtk_tpu_torch.ops.rasterize import rasterize
from drtk_tpu_torch.ops.render import render

__all__ = ["gather_frame", "make_row_sharded_forward"]


def _dim_index(mesh: DeviceMesh, name: str) -> int:
    if mesh.mesh_dim_names is None or name not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no dim {name!r} (dims {mesh.mesh_dim_names})")
    return mesh.mesh_dim_names.index(name)


def make_row_sharded_forward(
    mesh: DeviceMesh,
    vi: torch.Tensor,
    height: int,
    width: int,
    pix_axis: str = "pix",
    shade: Optional[Callable] = None,
) -> Callable:
    """Build ``forward(v, vt, tex) -> block`` for this rank of ``mesh``.

    ``v`` [n, V, 3] (pixel space), ``vt`` [n, V, 2] and ``tex`` [n, C, Ht,
    Wt] are this rank's cameras: the data row's share of the batch
    (``x[d * n:(d + 1) * n]`` for data index d), the same on every rank of
    its pix group. The block is rows ``[j * hb, (j + 1) * hb)`` of their
    [n, C, height, width] images, ``hb = height // P`` for pix index j of
    P; :func:`gather_frame` assembles the frame. The forward is
    differentiable end to end, edge_grad's gradients across block
    boundaries included: each rank's backward yields the gradient of the
    whole frame's loss to its inputs, once every rank of the mesh runs it.

    The block equals those rows of the single-process pipeline
    (``drtk_tpu_torch.pipeline.render_textured``) bit for bit; gradients
    agree to summation order.

    Args:
        mesh: a mesh with dims ("data", "pix"), e.g. from
            :func:`~drtk_tpu_torch.parallel.sharding.make_mesh`; this rank
            must lie in it.
        vi: [F, 3] int32 topology, on the inputs' device.
        height, width: the frame's size; ``height`` must divide by P.
        pix_axis: the mesh dim of the rows.
        shade: optional ``shade(vt_img [n, 2, hb, W], tex) -> [n, C, hb,
            W]``; by default ``tex`` sampled bilinearly at ``vt_img * 2 - 1``
            with border padding (``drtk_tpu/parallel/spmd.py:89-96``).

    On CUDA tensors the ops launch the kernels; on CPU tensors (CPU ranks
    under Gloo) their plain versions run.
    """
    if mesh.get_coordinate() is None:
        raise ValueError("make_row_sharded_forward: this rank is not in the mesh")
    dim = _dim_index(mesh, pix_axis)
    p_cnt = mesh.size(dim)
    if height % p_cnt != 0:
        raise ValueError(f"height {height} not divisible by pix-axis size {p_cnt}")
    hb = height // p_cnt
    y0 = mesh.get_local_rank(dim) * hb
    group = mesh.get_group(dim)

    if shade is None:

        def shade(vt_img, tex):
            uv = vt_img.movedim(1, -1) * 2.0 - 1.0
            return grid_sample(tex, uv, mode="bilinear", padding_mode="border", align_corners=False)

    def forward(v, vt, tex):
        # The backward span runs from the block's gradient to the inputs'.
        with tracing.span("forward", backward="backward") as sp:
            v, vt, tex = (psum_cotangent(x, group) for x in sp.grad_in(v, vt, tex))
            index_img = rasterize(v, vi, hb, width, y_offset=y0, full_height=height)
            _, bary = render(v, vi, index_img, y_offset=y0)
            vt_img = interpolate(vt, vi, index_img, bary, y_offset=y0, full_height=height)
            img = shade(vt_img, tex)
            img = img * (index_img != -1)[:, None]
            return sp.grad_out(edge_grad_estimator(
                v_pix=v, vi=vi, bary_img=bary, img=img, index_img=index_img, group=group, y_offset=y0,
                full_height=height,
            ))

    return forward


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    on_card = dist.get_backend(group) == "nccl"
    send = x.contiguous() if on_card else x.detach().cpu().contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_frame(block: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole [N, C, H, W] frame on every rank of a ("data", "pix")
    ``mesh`` from each rank's [n, C, hb, W] block: gathered over pix
    (rows), then over data (cameras). Not differentiable; for tests and
    checks. Every rank of the mesh calls it."""
    frame = _all_gather(block.detach(), mesh.get_group(_dim_index(mesh, "pix")), dim=2)
    return _all_gather(frame, mesh.get_group(_dim_index(mesh, "data")), dim=0)
