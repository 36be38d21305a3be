"""World-space -> pixel-space vertex transform (counterpart of
``drtk_tpu/transform.py``). Differentiable through autograd to the
vertices and every camera parameter."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from drtk_tpu_torch.utils.projection import project_points

__all__ = ["transform", "transform_with_v_cam"]


def transform(
    v: torch.Tensor,
    campos: Optional[torch.Tensor] = None,
    camrot: Optional[torch.Tensor] = None,
    focal: Optional[torch.Tensor] = None,
    princpt: Optional[torch.Tensor] = None,
    K: Optional[torch.Tensor] = None,
    Rt: Optional[torch.Tensor] = None,
    distortion_mode: Optional[Union[List[str], str]] = None,
    distortion_coeff: Optional[torch.Tensor] = None,
    fov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Project 3D vertex positions onto the camera image plane.

    Args:
        v: [N, V, 3] world-space vertices.
        campos [N, 3] and camrot [N, 3, 3], or Rt [N, 3, 4] (world to
            camera): exactly one of the two.
        focal [N, 2, 2] and princpt [N, 2], or K [N, 3, 3]: exactly one.
        distortion_mode, distortion_coeff, fov: the lens model, see
            :func:`drtk_tpu_torch.utils.projection.project_points`.

    Returns:
        [N, V, 3]: (x_pix, y_pix, z_cam), the mixed-unit space the
        rasterizer and the edge-gradient normal math expect.
    """
    v_pix, _ = transform_with_v_cam(
        v, campos, camrot, focal, princpt, K, Rt, distortion_mode, distortion_coeff, fov
    )
    return v_pix


def transform_with_v_cam(
    v: torch.Tensor,
    campos: Optional[torch.Tensor] = None,
    camrot: Optional[torch.Tensor] = None,
    focal: Optional[torch.Tensor] = None,
    princpt: Optional[torch.Tensor] = None,
    K: Optional[torch.Tensor] = None,
    Rt: Optional[torch.Tensor] = None,
    distortion_mode: Optional[Union[List[str], str]] = None,
    distortion_coeff: Optional[torch.Tensor] = None,
    fov: Optional[torch.Tensor] = None,
    lut_vector_field: Optional[torch.Tensor] = None,
    lut_spacing: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same as :func:`transform`, and also returns the camera-space
    coordinates [N, V, 3]; ``lut_vector_field`` and ``lut_spacing`` are
    Fisheye62's pixel-space correction."""
    if not ((camrot is not None and campos is not None) ^ (Rt is not None)):
        raise ValueError("You must provide exactly one of Rt or (campos, camrot).")
    if not ((focal is not None and princpt is not None) ^ (K is not None)):
        raise ValueError("You must provide exactly one of K or (focal, princpt).")

    if Rt is not None:
        camrot = Rt[:, :3, :3]
        campos = -torch.einsum("nji,njk->nik", camrot, Rt[:, :3, 3:4])[..., 0]
    if K is not None:
        focal = K[:, :2, :2]
        princpt = K[:, :2, 2]

    return project_points(
        v=v,
        campos=campos,
        camrot=camrot,
        focal=focal,
        princpt=princpt,
        distortion_mode=distortion_mode,
        distortion_coeff=distortion_coeff,
        fov=fov,
        lut_vector_field=lut_vector_field,
        lut_spacing=lut_spacing,
    )
