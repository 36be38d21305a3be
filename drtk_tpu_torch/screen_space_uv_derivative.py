"""The per-pixel screen-space uv Jacobian for mipmapped sampling
(counterpart of ``drtk_tpu/screen_space_uv_derivative.py``).

``vt_dxdy_img`` [N, H, W, 2, 2] holds ``[[du/dx, dv/dx], [du/dy, dv/dy]]``,
the uv field's derivative with respect to the pixel position, which
:func:`~drtk_tpu_torch.ops.mipmap_grid_sample.mipmap_grid_sample` takes:

1. the per-face (dp/dt)^T (:func:`~drtk_tpu_torch.utils.geometry.face_dpdt`);
2. interpolated per pixel over a discontinuous index list, ``vi_dis =
   arange(3F)``, so that face-constant values never blend across faces
   (kernel B2 gathers the rows on the card, 3 x 6 and 3 x 3 floats per face);
3. pushed through the projection's Jacobian-vector product
   (:func:`~drtk_tpu_torch.utils.projection.project_points_grad`) to
   (d p_pix / dt)^T;
4. inverted per pixel (zeros where singular) and zeroed outside the mask.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from drtk_tpu_torch.ops.interpolate import interpolate
from drtk_tpu_torch.utils.geometry import _inv_2x2_or_zero, face_dpdt
from drtk_tpu_torch.utils.projection import project_points_grad

__all__ = ["screen_space_uv_derivative"]


def screen_space_uv_derivative(
    v: torch.Tensor,
    vt: torch.Tensor,
    vi: torch.Tensor,
    vti: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
    mask: torch.Tensor,
    campos: torch.Tensor,
    camrot: torch.Tensor,
    focal: torch.Tensor,
    dist_mode: Optional[Sequence[str]] = None,
    dist_coeff: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """The per-pixel uv Jacobian with respect to the pixel position.

    Args:
        v: [N, V, 3] world-space vertices; vt: [N, Vt, 2] uvs.
        vi / vti: [F, 3] int32 position and uv faces.
        index_img: [N, H, W] int32 triangle index image; bary_img:
            [N, 3, H, W]; mask: [N, H, W] bool foreground.
        campos, camrot, focal: the cameras, as for
            :func:`~drtk_tpu_torch.utils.projection.project_points`.
        dist_mode, dist_coeff: the lens; only the pinhole Jacobian is
            defined (:func:`~drtk_tpu_torch.utils.projection.project_points_grad`).
        impl: "auto" gathers the face rows with kernel B2 on CUDA tensors;
            "plain" uses the plain gather on any device.

    Returns:
        [N, H, W, 2, 2] ``vt_dxdy_img``, zero outside ``mask``.
    """
    n = v.shape[0]
    f_cnt = vi.shape[-2]
    dpdt_t, vf = face_dpdt(v, vt, vi, vti)  # [N, F, 2, 3], [N, F, 3, 3]
    # The face-constant Jacobian at each of the face's own three vertices.
    dpdt3 = dpdt_t[:, :, None].expand(n, f_cnt, 3, 2, 3).reshape(n, f_cnt * 3, 6)
    vi_dis = torch.arange(3 * f_cnt, dtype=torch.int32, device=v.device).reshape(-1, 3)

    dpdt_img = interpolate(dpdt3, vi_dis, index_img, bary_img, impl=impl).movedim(1, -1)  # [N, H, W, 6]
    h, w = dpdt_img.shape[1:3]
    dpdt_img = dpdt_img.reshape(n, h, w, 2, 3)
    vf_img = interpolate(vf.reshape(n, f_cnt * 3, 3), vi_dis, index_img, bary_img, impl=impl).movedim(1, -1)
    # The surface position, once for the u and once for the v direction.
    vf2_img = vf_img[:, :, :, None].expand(n, h, w, 2, 3)

    dp_pix_dt_t = project_points_grad(
        dpdt_img.reshape(n, -1, 3), vf2_img.reshape(n, -1, 3), campos, camrot, focal, dist_mode, dist_coeff
    ).reshape(n, h, w, 2, 2)
    return torch.where(mask[..., None, None], _inv_2x2_or_zero(dp_pix_dt_t), dp_pix_dt_t.new_zeros(()))
