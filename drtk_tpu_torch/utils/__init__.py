"""Camera, geometry and indexing utilities (counterpart of ``drtk_tpu/utils``)."""

from drtk_tpu_torch.utils.geometry import (
    face_attribute_to_vert,
    face_dpdt,
    face_info,
    vert_binormals,
    vert_normals,
)
from drtk_tpu_torch.utils.indexing import index
from drtk_tpu_torch.utils.projection import (
    DISTORTION_MODES,
    estimate_fisheye62_fov,
    estimate_fisheye_fov,
    estimate_rt_fov,
    project_pinhole,
    project_points,
    project_points_grad,
)

__all__ = [
    "DISTORTION_MODES",
    "estimate_fisheye62_fov",
    "estimate_fisheye_fov",
    "estimate_rt_fov",
    "face_attribute_to_vert",
    "face_dpdt",
    "face_info",
    "index",
    "project_pinhole",
    "project_points",
    "project_points_grad",
    "vert_binormals",
    "vert_normals",
]
