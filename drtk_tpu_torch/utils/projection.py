"""Pinhole camera projection (counterpart of the pinhole part of
``drtk_tpu/utils/projection.py``).

Differentiable through autograd, as the JAX package's is through its
autodiff. The distortion models ("radial-tangential", "fisheye",
"fisheye62", "fisheye62_lut") are not ported yet (ROADMAP queue A item 15)
and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

__all__ = ["DISTORTION_MODES", "project_pinhole", "project_points"]

DISTORTION_MODES = {None, "pinhole", "radial-tangential", "fisheye"}
_PINHOLE_MODES = {None, "pinhole"}
_UNPORTED_MODES = {"radial-tangential", "fisheye", "fisheye62", "fisheye62_lut"}


def _signclamp(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """z away from zero, keeping its sign (0 goes to +eps). ``maximum`` and
    ``minimum`` split the gradient at a tie, as JAX's do."""
    e = torch.tensor(eps, dtype=z.dtype, device=z.device)
    return torch.where(z < 0, torch.minimum(z, -e), torch.maximum(z, e))


def project_pinhole(v_cam: torch.Tensor, focal: torch.Tensor, princpt: torch.Tensor) -> torch.Tensor:
    """Undistorted pinhole projection.

    v_cam: [N, V, 3]; focal: [N, 2, 2]; princpt: [N, 2] -> [N, V, 2].
    """
    z = _signclamp(v_cam[:, :, 2:3])
    v_proj = v_cam[:, :, 0:2] / z
    return torch.einsum("nij,nvj->nvi", focal, v_proj) + princpt[:, None]


def _unported(mode) -> NotImplementedError:
    return NotImplementedError(
        f"project_points: distortion mode {mode!r} is not ported yet (ROADMAP queue A item 15); "
        "only pinhole projection is available"
    )


def project_points(
    v: torch.Tensor,
    campos: torch.Tensor,
    camrot: torch.Tensor,
    focal: torch.Tensor,
    princpt: torch.Tensor,
    distortion_mode: Optional[Union[List[str], str]] = None,
    distortion_coeff: Optional[torch.Tensor] = None,
    fov: Optional[torch.Tensor] = None,
    lut_vector_field: Optional[torch.Tensor] = None,
    lut_spacing: Optional[torch.Tensor] = None,
):
    """Project world-space vertices to pixel coordinates.

    Args:
        v: [N, V, 3] world-space vertices.
        campos: [N, 3] camera positions; camrot: [N, 3, 3] world-to-camera
            rotations; focal: [N, 2, 2]; princpt: [N, 2].
        distortion_mode: None or "pinhole", or a per-batch list of them.
            Other modes raise NotImplementedError; unknown ones ValueError.
        distortion_coeff: required whenever ``distortion_mode`` is given,
            as in the JAX package; pinhole projection does not read it.
        fov, lut_vector_field, lut_spacing: read only by the unported
            distortion models.

    Returns:
        ``(v_pix, v_cam)``, each [N, V, 3]: ``v_pix`` holds (x_pix, y_pix,
        z_cam), ``v_cam`` the camera-space positions.
    """
    if distortion_mode is not None and distortion_coeff is None:
        raise ValueError("project_points: missing distortion coefficients")
    modes = set(distortion_mode) if isinstance(distortion_mode, (list, tuple)) else {distortion_mode}
    for mode in modes:
        if mode in _UNPORTED_MODES:
            raise _unported(mode)
        if mode not in _PINHOLE_MODES:
            raise ValueError(f"project_points: invalid distortion mode {mode!r}; valid options: {DISTORTION_MODES}")

    v_cam = torch.einsum("nij,nvj->nvi", camrot, v - campos[:, None])
    v_pix = project_pinhole(v_cam, focal, princpt)
    return torch.cat([v_pix, v_cam[:, :, 2:3]], dim=-1), v_cam
